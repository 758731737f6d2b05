"""The port's ED / N-ICP evaluation (``cli/eval_ed.py``) against the JAX
package's on the CPU: ``evaluate_pair_ed`` on ``tests/test_eval_ed.py``'s
synthetic depth pair, without and with its landmark stub, then the CLI
(``main(argv)``) on a fabricated one-pair depth split, ``eval_nolearned``'s
delegation of ``config/baselines/NICP.yaml``, and ``--visualize``.

With ``samples`` at least both cloud sizes the two solvers see the same
loss (their random streams differ). Tolerances: the evaluated (valid) set
equal; the flow within 1e-3 after one iteration; after 30 iterations, on
average over the points, no farther from JAX's than 3x the JAX package's
own spread between two keys (on these pairs the reference's own
trajectories part within a few iterations), and an error against the true
flow no more than 1% above the worse key's.
"""
import os
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from deformationpyramid_tpu.cli import eval_ed as jeval
from deformationpyramid_tpu.data.fourdmatch import Pair as JPair
from deformationpyramid_tpu.geometry.camera import depth_to_pointcloud
from deformationpyramid_tpu.solve.baselines import EDSolverConfig as JCfg
from deformationpyramid_tpu.utils.config import AttrDict
from deformationpyramid_tpu_torch.cli import eval_ed as teval
from deformationpyramid_tpu_torch.cli import eval_nolearned as tnolearned
from deformationpyramid_tpu_torch.data.fourdmatch import Pair as TPair
from deformationpyramid_tpu_torch.data.synthetic import write_4dmatch_suite
from deformationpyramid_tpu_torch.solve.baselines import EDSolverConfig as TCfg

sys.path.insert(0, str(Path(__file__).resolve().parent))
from depth_pairs import write_ed_split  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CFG = {"max_triangle_distance": 0.1, "node_coverage": 0.12,
       "num_neighbors": 6}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _synthetic_pair(tmp_path, h, w, f, shift):
    """``tests/test_eval_ed.py``'s pair: a wavy depth map (mm) and the
    same surface shifted, whose depth map moves in z only."""
    yy, xx = np.mgrid[0:h, 0:w]
    depth = 1.0 + 0.04 * np.sin(xx / 6.0) * np.cos(yy / 8.0)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    np.save(tmp_path / "s.npy", (depth * 1000).astype(np.float32))
    np.save(tmp_path / "t.npy", ((depth + shift[2]) * 1000).astype(np.float32))
    src = depth_to_pointcloud(depth, K).reshape(3, -1).T.astype(np.float32)
    kw = dict(src=src, tgt=src + shift, flow_gt=np.tile(shift, (len(src), 1)),
              overlap=np.ones(len(src), bool),
              rot=np.eye(3, dtype=np.float32),
              trans=np.zeros((3, 1), np.float32),
              correspondences=np.zeros((0, 2), np.int64),
              depth_paths=(str(tmp_path / "s.npy"), str(tmp_path / "t.npy")),
              cam_intrin=K)
    return JPair(**kw), TPair(**kw)


def _stub(shift):
    """``tests/test_eval_ed.py:56``'s oracle landmarks."""
    def landmark_fn(src_pts, tgt_pts):
        pick = np.random.default_rng(0).permutation(len(src_pts))[:16]
        return src_pts[pick], src_pts[pick] + shift, np.ones(16, bool)
    return landmark_fn


def _both(tmp_path, landmarks, iters, keys=(0,)):
    if landmarks:
        shift = np.array([0.08, -0.05, 0.03], np.float32)
        jpair, tpair = _synthetic_pair(tmp_path, 40, 48, 70.0, shift)
        kw = dict(w_ldmk=1.0, w_cd=0.1)
    else:
        shift = np.array([0.1, -0.06, 0.04], np.float32)
        jpair, tpair = _synthetic_pair(tmp_path, 50, 60, 80.0, shift)
        kw = {}
    fn = _stub(shift) if landmarks else None
    jout = [jeval.evaluate_pair_ed(
        jpair, AttrDict(CFG), JCfg(iters=iters, samples=4096,
                                   use_pallas=False, **kw),
        jax.random.key(k), landmark_fn=fn) for k in keys]
    info = {}
    tflow, tgt, tov = teval.evaluate_pair_ed(
        tpair, AttrDict(CFG), TCfg(iters=iters, samples=4096, **kw), 0,
        landmark_fn=fn, device="cpu", info=info)
    _, jgt, jov = jout[0]
    assert np.array_equal(tgt, jgt) and np.array_equal(tov, jov)
    assert len(tflow) > 100 and np.isfinite(tflow).all()
    assert info["iters"] == iters and set(info["graph_seconds"]) == {
        "mesh", "nodes", "dijkstra", "anchors"}
    if landmarks:       # coordinates mapped to raw-cloud indices
        s_idx = info["landmarks"]["src_ldmk_idx"]
        assert s_idx.dtype == np.int64 and len(s_idx) == 16
        assert (s_idx < info["n_vertices"]).all()
        assert (info["landmarks"]["tgt_ldmk_idx"] < info["n_target"]).all()
    return tflow, [o[0] for o in jout]


@pytest.mark.parametrize("landmarks", [False, True])
def test_evaluate_pair_ed_matches_jax(tmp_path, landmarks):
    """One iteration: the graph, the clouds, the landmark mapping, the
    loss and Adam's first step, and the pixel-map propagation agree."""
    tflow, (jflow,) = _both(tmp_path, landmarks, 1)
    assert float(np.abs(tflow - jflow).max()) < 1e-3


@pytest.mark.parametrize("landmarks", [False, True])
def test_evaluate_pair_ed_within_the_references_own_spread(tmp_path,
                                                           landmarks):
    """30 iterations. On this pixel-grid pair the JAX package's expanded
    distance rounds near-equal candidates into ties, whose first index
    depends on the sample order, and Adam turns the difference into whole
    steps: the JAX flows of two keys (which only reorder the samples) end
    0.4-2 cm apart on average. The port must end no farther from JAX's
    flow, on average over the points, than 3x that spread, and its error
    against the true flow may exceed the worse JAX key's by 1% at most."""
    tflow, (j0, j1) = _both(tmp_path, landmarks, 30, keys=(0, 1))
    dist = lambda a, b: float(np.linalg.norm(a - b, axis=1).mean())  # noqa
    assert dist(tflow, j0) <= 3.0 * dist(j1, j0)
    gt = np.tile(np.array([0.08, -0.05, 0.03] if landmarks
                          else [0.1, -0.06, 0.04], np.float32),
                 (len(tflow), 1))
    assert dist(tflow, gt) <= 1.01 * max(dist(j0, gt), dist(j1, gt))


def test_main_scores_a_depth_split_and_skips_pairs_without_depth(tmp_path):
    write_ed_split(str(tmp_path), "4DMatch-F", n_pairs=1, h=60, w=80,
                   n_eval=800)
    write_4dmatch_suite(str(tmp_path), "4DLoMatch-F", n_pairs=1,
                        size_clusters=(150,), seed=2)
    cfg = tmp_path / "ed.yaml"
    cfg.write_text("deformation_model: ED\niters: 30\nsamples: 300\n"
                   f"data_root: {tmp_path}\nnode_coverage: 0.12\n")
    report = teval.main(["--config", str(cfg), "--device", "cpu"])
    assert list(report) == ["4DMatch-F"]         # 4DLoMatch-F: no depth maps
    rep = report["4DMatch-F"]
    assert rep["pairs"] == 1 and len(rep["scores"]) == 12
    assert all(np.isfinite(v) for v in rep["scores"].values())
    assert 1 <= list(rep["iters"].values())[0] <= 30


def test_eval_nolearned_delegates_ed_configs(tmp_path, monkeypatch):
    write_ed_split(str(tmp_path), "4DMatch-F", n_pairs=1, h=48, w=64,
                   n_eval=500)
    seen = {}
    real = teval.main

    def spy(argv):
        seen["argv"] = argv
        return real(argv)

    monkeypatch.setattr(teval, "main", spy)
    report = tnolearned.main(
        ["--config", str(REPO / "config/baselines/NICP.yaml"), "--splits",
         "4DMatch-F", "--data-root", str(tmp_path), "--device", "cpu"])
    assert seen["argv"][:2] == ["--config",
                                str(REPO / "config/baselines/NICP.yaml")]
    rep = report["4DMatch-F"]
    assert rep["pairs"] == 1 and len(rep["scores"]) == 12
    assert 1 <= list(rep["iters"].values())[0] <= 600


def test_visualize_raises(tmp_path):
    """--visualize no longer raises: each pair's deformation graph goes to
    <vis_dir>/<pair>_graph.ply (the JAX writer's bytes) and .png."""
    from deformationpyramid_tpu.utils import vis as jvis

    jpair, tpair = _synthetic_pair(tmp_path, 20, 24, 40.0,
                                   np.array([0.0, 0.0, 0.01], np.float32))
    info = {}
    teval.evaluate_pair_ed(tpair, AttrDict(CFG), TCfg(iters=2), 0,
                           vis_dir=str(tmp_path / "vis"), device="cpu",
                           info=info)
    base = os.path.join(tmp_path / "vis", tpair.name.replace("/", "_"))
    assert Path(base + "_graph.png").stat().st_size > 0
    g = teval.build_deformation_graph_from_depth(
        teval._read_depth(tpair.depth_paths[0]), tpair.cam_intrin,
        max_triangle_distance=CFG["max_triangle_distance"],
        node_coverage=CFG["node_coverage"],
        n_max_neighbors=CFG.get("num_neighbors", 8),
        remove_sparse_nodes=CFG.get(
            "REMOVE_NODES_WITH_NOT_ENOUGH_NEIGHBORS", True))
    jvis.export_graph_ply(str(tmp_path / "j.ply"), g.nodes, g.edges,
                          edges_valid=g.edges_valid)
    assert Path(base + "_graph.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    rep = teval.main(["--config", str(REPO / "config/baselines/NICP.yaml"),
                      "--visualize", "--device", "cpu", "--data-root",
                      str(tmp_path / "none"), "--log-dir",
                      str(tmp_path / "log")])
    assert rep == {}
