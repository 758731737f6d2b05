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
import torch
import deformationpyramid_tpu_torch as dp
from deformationpyramid_tpu_torch.data.synthetic import make_pair
from deformationpyramid_tpu_torch.solve import loop, registration
from deformationpyramid_tpu_torch.ops import chamfer, cuda_lib, fused_iteration, knn
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
