"""The PyTorch port imports no JAX, not even indirectly: in a fresh
interpreter, import the port and run a tiny registration, then check
``sys.modules``."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)    # small tensors; parallel test workers
import deformationpyramid_tpu_torch as dp
from deformationpyramid_tpu_torch.data.synthetic import make_pair
from deformationpyramid_tpu_torch.solve import loop, registration
from deformationpyramid_tpu_torch.ops import chamfer, cuda_lib, fused_iteration, knn
from deformationpyramid_tpu_torch.ops import chamfer_fused, fused_level
import bench_torch
import runpy
for script in ("parity_torch_vs_ledger", "suite_parity_torch",
               "check_torch_optin_kernels", "check_torch_nn_argmin",
               "profile_torch_streaming"):
    runpy.run_path(f"scripts/{script}.py", run_name="not_main")
from deformationpyramid_tpu_torch.metrics import flow, matching
from deformationpyramid_tpu_torch.data import (
    collate, correspondence_utils, fourdmatch, ply, synthetic)
from deformationpyramid_tpu_torch.cli import (
    eval_nolearned, shape_transfer, train_matcher, train_neco)
from deformationpyramid_tpu_torch import losses as dp_losses
from deformationpyramid_tpu_torch.models import baselines as model_baselines
from deformationpyramid_tpu_torch.ops import sinkhorn
from deformationpyramid_tpu_torch.solve import baselines as solve_baselines
from deformationpyramid_tpu_torch.utils import reporting, timers
from deformationpyramid_tpu_torch.train import trainer
from deformationpyramid_tpu_torch.utils import checkpoint, config, logging
from deformationpyramid_tpu_torch.match import (
    attention, backbone, config_loader, kernel_points, kpconv, landmark,
    losses, matching as match_matching, outlier_rejection, pipeline,
    position_encoding, procrustes, transformer)

src, tgt, _ = make_pair(n=120, seed=0)
for fused in (False, True):
    cfg = dp.SolverConfig(pyramid=dp.NDPConfig(m=2, width=16), iters=5,
                          samples=80, use_fused_iteration=fused)
    warped, stats = dp.register_pair(0, torch.from_numpy(src),
                                     torch.from_numpy(tgt), cfg)
    assert torch.isfinite(warped).all()
# the opt-in routes and the nonrigidity head
for opts in (dict(use_fused=True, use_fused_chamfer=True),
             dict(use_fused=True, transposed=True)):
    cfg = dp.SolverConfig(pyramid=dp.NDPConfig(m=2, width=16), iters=5,
                          samples=80, **opts)
    warped, _ = dp.register_pair(0, torch.from_numpy(src),
                                 torch.from_numpy(tgt), cfg)
    assert torch.isfinite(warped).all()
cfg = dp.SolverConfig(pyramid=dp.NDPConfig(m=2, width=16,
                                           nonrigidity_est=True),
                      iters=5, samples=80, w_reg=0.2,
                      use_fused_iteration=True)
warped, _ = dp.register_pair(0, torch.from_numpy(src), torch.from_numpy(tgt),
                             cfg)
assert torch.isfinite(warped).all()
for w_cd in (0.0, 1.0):
    cfg = dp.SolverConfig(pyramid=dp.NDPConfig(m=2, width=16), iters=5,
                          samples=80, w_cd=w_cd, use_fused_iteration=True,
                          use_fused_ldmk=True)
    s = torch.from_numpy(src)
    warped, _ = dp.register_pair(0, s, torch.from_numpy(tgt), cfg,
                                 src_ldmk=s[:20], tgt_ldmk=s[:20] + 0.01)
    assert torch.isfinite(warped).all()
# the landmark model at a narrow width, through the streamed route's plain
# version, then the solver with its landmarks
kp = kpconv.KPConvConfig(first_subsampling_dl=0.05, first_feats_dim=16,
                         coarse_feature_dim=24, fine_feature_dim=12)
mc = match_matching.MatchingConfig(feature_dim=24)
vol = position_encoding.VolPEConfig(feature_dim=24,
                                    vol_origin=(-2.0, -2.0, -2.0))
lcfg = landmark.LandmarkConfig(
    matcher=pipeline.MatcherConfig(
        kpfcn=kp, matching=mc, transformer=transformer.TransformerConfig(
            feature_dim=24, n_head=4, vol=vol, matching=mc,
            attention_impl="flash")),
    neco=outlier_rejection.NeCoConfig(feature_dim=24, n_head=4, num_layers=2))
lcfg2 = config_loader.landmark_config_from_yaml(
    "config/configs/correspondence.yaml")
assert lcfg2.matcher.kpfcn.coarse_feature_dim == 528
limits = collate.calibrate_neighborhood_limits(
    [(src, tgt)], kp, backbone.KPFCN_ARCHITECTURE)
pyr = collate.build_pair_pyramid(src, tgt, kp, backbone.KPFCN_ARCHITECTURE,
                                 limits)
params = landmark.init_landmark_model(torch.Generator().manual_seed(0), lcfg,
                                     "cpu")
out = landmark.landmark_inference(
    params, collate.pyramid_to_device(pyr, "cpu"), pyr.src_lengths[2],
    pyr.tgt_lengths[2], lcfg, s_cap=64, t_cap=64)
assert torch.isfinite(out["conf_matrix_pred"]).all()
cfg = dp.SolverConfig(pyramid=dp.NDPConfig(m=2, width=16), iters=5,
                      samples=80, w_cd=0.0, use_fused_iteration=True,
                      use_fused_ldmk=True)
warped, _ = dp.register_pair(0, torch.from_numpy(src), torch.from_numpy(tgt),
                             cfg, src_ldmk=out["ldmk_s"],
                             tgt_ldmk=out["ldmk_t"],
                             ldmk_valid=out["ldmk_valid"])
assert torch.isfinite(warped).all()
# one narrow training step of each trainer, through the CLIs' batch streams
import tempfile
with tempfile.TemporaryDirectory() as root:
    synthetic.write_4dmatch_suite(root, "train", n_pairs=1,
                                  size_clusters=(150,), seed=1)
    ds = fourdmatch.FourDMatchDataset(root, "train")
    tcfg = trainer.TrainConfig(optimizer="Adam", lr=1e-3, max_epoch=1,
                               snapshot_dir=root + "/snap")
    mp = trainer.train_matcher(
        params["matcher"], lcfg, tcfg,
        train_matcher.make_matcher_batch_stream(ds, lcfg, limits, 0.1,
                                                device="cpu"),
        steps_per_epoch=1, log_fn=lambda *_: None)
    moved = [float((a - b).abs().max()) for a, b in zip(
        dp.models.pyramid.tree_leaves(mp),
        dp.models.pyramid.tree_leaves(params["matcher"]))]
    assert max(moved) > 0
    neco = trainer.train_neco(
        mp, params["neco"], lcfg, tcfg,
        train_neco.make_batch_stream(ds, lcfg, limits, device="cpu"),
        steps_per_epoch=1, log_fn=lambda *_: None)
    back = checkpoint.load_pytree(root + "/snap/model_last.npz", neco)
    assert all(torch.equal(a, b) for a, b in zip(
        dp.models.pyramid.tree_leaves(back),
        dp.models.pyramid.tree_leaves(neco)))
# the no-learned evaluation CLI on a fabricated split: NDP on the fast
# path, NSFP fused, Nerfies and Sinkhorn
with tempfile.TemporaryDirectory() as root:
    synthetic.write_4dmatch_suite(root, "4DMatch-F", n_pairs=1,
                                  size_clusters=(150,), seed=2)
    for name, body in (
            ("NDP", "m: 2\\nwidth: 16\\niters: 4\\nrotation_format: 6D\\n"),
            ("NSFP", "iters: 4\\nuse_fused_iteration: true\\n"),
            ("Nerfies", "iters: 2\\n"), ("Sinkhorn", "Nsteps: 2\\n")):
        path = f"{root}/{name}.yaml"
        with open(path, "w") as f:
            f.write(f"deformation_model: {name}\\nsamples: 60\\n"
                    f"data_root: {root}\\n" + body)
        scores = eval_nolearned.main(
            ["--config", path, "--splits", "4DMatch-F", "--device", "cpu",
             "--log-dir", f"{root}/snap_{name}"])
        assert len(scores["4DMatch-F"]["scores"]) == 12
# the ED / N-ICP evaluation on a fabricated depth pair, and the renderer
from deformationpyramid_tpu_torch.cli import eval_ed
from deformationpyramid_tpu_torch.data import graph
from deformationpyramid_tpu_torch.geometry import camera, kabsch
from deformationpyramid_tpu_torch.ops import render
sys.path.insert(0, "tests")
from depth_pairs import write_ed_split
with tempfile.TemporaryDirectory() as root:
    write_ed_split(root, "4DMatch-F", n_pairs=1, h=48, w=64, n_eval=300)
    with open(f"{root}/ed.yaml", "w") as f:
        f.write(f"deformation_model: ED\\niters: 5\\nsamples: 200\\n"
                f"data_root: {root}\\nnode_coverage: 0.12\\n")
    rep = eval_nolearned.main(["--config", f"{root}/ed.yaml", "--splits",
                               "4DMatch-F", "--device", "cpu"])
    assert rep["4DMatch-F"]["pairs"] == 1
x = torch.rand(50, 3) + torch.tensor([0.0, 0.0, 1.0])
total, _, _ = dp_losses.point_2_plane_distance(x, x + 0.01, x, x)
depth, sil = render.render_depth_silhouette(
    x, torch.tensor([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]]),
    render.RenderConfig(48, 64))
assert torch.isfinite(total) and sil.sum() > 0
# the learned evaluations: LNDP on a fabricated split and 3DMatch on
# fabricated fragments, with the narrow landmark model
from deformationpyramid_tpu_torch.cli import eval_3dmatch, eval_supervised
from deformationpyramid_tpu_torch.data import threedmatch
from deformationpyramid_tpu_torch.metrics import registration
from deformationpyramid_tpu_torch.utils.config import AttrDict
import bench_lndp_torch
runpy.run_path("scripts/learning_torch.py", run_name="not_main")
with tempfile.TemporaryDirectory() as root:
    synthetic.write_4dmatch_suite(root, "4DMatch-F", n_pairs=1,
                                  size_clusters=(150,), seed=2)
    scfg = dp.SolverConfig(pyramid=dp.NDPConfig(m=2, width=16), iters=4,
                           samples=60)
    rep = eval_supervised.run_eval(AttrDict({"data_root": root}), lcfg,
                                   params, scfg, ["4DMatch-F"],
                                   log_dir=root + "/lndp", device="cpu")
    assert len(rep["4DMatch-F"]["scores"]) == 17
    info = synthetic.write_3dmatch_suite(root, "3DMatch", n_pairs=1,
                                         n_scene=300, seed=1)
    ds3 = threedmatch.ThreeDMatchDataset(info, root)
    s3 = eval_3dmatch.run_eval_3dmatch(lcfg, params, ds3, ds3.infos["gt_cov"],
                                       log_dir=root + "/3dm",
                                       ransac_iters=20, device="cpu")
    assert 0.0 <= s3["value"] <= 1.0
# the multiview stack, one narrow training step through the CLI's step
from deformationpyramid_tpu_torch.cli import train_multiview
from deformationpyramid_tpu_torch.data import fourdmatch_multiview
from deformationpyramid_tpu_torch.match import multiview, port_torch
from deformationpyramid_tpu_torch.parallel import batched, mesh
from deformationpyramid_tpu_torch.utils import debug, seed, vis
with tempfile.TemporaryDirectory() as root:
    synthetic.write_multiview_suite(root, "mv", n_seqs=1, n_views=3,
                                    n_pts=60)
    mv = fourdmatch_multiview.FourDMatchMultiview(root, "mv")
    mcfg = multiview.MultiviewNeCoConfig(neco=outlier_rejection.NeCoConfig(
        feature_dim=24, n_head=4, num_layers=1))
    batch = train_multiview.make_training_batch(
        mv[0], 8, 0.4, 6, 512, np.random.default_rng(0), 0.1)
    mparams = multiview.init_multiview_neco(seed.setup_seed(0), mcfg)
    opt = train_multiview.adam(1e-3)
    _, _, mloss, _ = train_multiview.make_train_step(mcfg, opt)(
        mparams, opt.init(mparams), *[torch.from_numpy(b) for b in batch])
    assert torch.isfinite(mloss)
    err, _ = debug.checkified(lambda: mloss)()
    err.throw()
    vis.export_pcds_ply(root + "/p.ply", src_pcd=src)
    with timers.trace(root + "/trace"):
        multiview.apply_nonlocalnet(
            multiview.init_nonlocalnet(seed.setup_seed(1),
                                       multiview.NonLocalNetConfig(
                                           num_layers=1, num_channels=16)),
            torch.from_numpy(batch[0][0]), torch.from_numpy(batch[1][0]),
            multiview.NonLocalNetConfig(num_layers=1, num_channels=16))
# sharded_nn_min on a 1-rank gloo mesh
import socket
import torch.distributed as tdist
with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    free = sock.getsockname()[1]
tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free}",
                         world_size=1, rank=0)
x = torch.from_numpy(src[:40])
got = batched.sharded_nn_min(mesh.make_mesh())(x, torch.from_numpy(tgt))
assert torch.equal(got, knn.nn_argmin(x, torch.from_numpy(tgt))[0])
tdist.destroy_process_group()
# a NeCo checkpoint in the reference's layout
nd = lcfg.neco.feature_dim
sd = {"in_proj.weight": np.ones((nd, 6), np.float32),
      "in_proj.bias": np.zeros(nd, np.float32)}
ported, rep = port_torch.port_neco(sd, params["neco"])
assert "in_proj.weight" in rep["used"] and rep["missing"]
# continuous batching through bench_torch.py --streaming, the native
# collate library, bf16 matcher inference and the [3, N] route
bench_torch.CFG = dp.SolverConfig(pyramid=dp.NDPConfig(m=2, width=16),
                                  iters=5, samples=40)
line = bench_torch.main(["--streaming", "--device", "cpu", "--total", "2",
                         "--slots", "2", "--n", "48", "--k-inner", "4"])
assert line["value"] > 0
from deformationpyramid_tpu_torch import native
from deformationpyramid_tpu_torch.solve import streaming
assert collate._native() is native
assert native.grid_subsample(src, 0.1).shape[1] == 3
assert native.radius_neighbors(src, tgt, 0.1, 8).shape == (len(src), 8)
bf = lcfg.matcher.transformer.__class__(
    feature_dim=24, n_head=4, vol=vol, matching=mc, compute_dtype="bfloat16")
bf_out = landmark.landmark_inference(
    params, collate.pyramid_to_device(pyr, "cpu"), pyr.src_lengths[2],
    pyr.tgt_lengths[2], landmark.LandmarkConfig(
        matcher=pipeline.MatcherConfig(kpfcn=kp, matching=mc, transformer=bf),
        neco=lcfg.neco), s_cap=64, t_cap=64)
assert torch.isfinite(bf_out["conf_matrix_pred"]).all()
cfg = dp.SolverConfig(pyramid=dp.NDPConfig(m=2, width=16), iters=5,
                      samples=80, transposed=True)
warped, _ = dp.register_pair(0, torch.from_numpy(src), torch.from_numpy(tgt),
                             cfg)
assert torch.isfinite(warped).all()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("jaxlib") or m == "deformationpyramid_tpu"
             or m.startswith("deformationpyramid_tpu."))
print("JAX_MODULES", bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX_MODULES []" in proc.stdout
