"""The port's 3DMatch path against the JAX package's, on the CPU: the two
fragment-suite writers (every file's bytes equal: the .npy files whole, the
.npz archives member by member, since a zip stamps its write time), the
dataset reader (the same pairs), and ``run_eval_3dmatch`` on 2 fragments
of 500 points at ``tests/test_eval_3dmatch.py``'s configuration (FD 96,
NeCo 48 wide with 2 layers, rejection off, 200 RANSAC iterations) with the
JAX init's weights.

Tolerances: the same ledger keys; ``n_matches`` and ``recall_ok`` equal
(the matches are no near-ties at these weights); ``trans_err``, ``RTE`` and
``RRE_deg`` within 1e-4 relative (the RANSAC is bit-identical on equal
matches: what differs is the matcher's float32 coordinates, ~1e-6).
"""
import json
import os
import zipfile
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from deformationpyramid_tpu.cli import eval_3dmatch as jev
from deformationpyramid_tpu.data import synthetic as jsyn
from deformationpyramid_tpu.data.fourdmatch import FourDMatchDataset as JDS
from deformationpyramid_tpu.data.threedmatch import ThreeDMatchDataset as J3D
from deformationpyramid_tpu.match import landmark as jl
import deformationpyramid_tpu_torch as tdp
from deformationpyramid_tpu_torch.cli import eval_3dmatch as tev
from deformationpyramid_tpu_torch.data import synthetic as tsyn
from deformationpyramid_tpu_torch.data.fourdmatch import FourDMatchDataset
from deformationpyramid_tpu_torch.data.threedmatch import ThreeDMatchDataset

from test_torch_eval_supervised import JMODS, TMODS, landmark_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_bytes(root):
    """{relative path: bytes} of a written suite, npz archives by member."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".npz"):
                with zipfile.ZipFile(path) as z:
                    for m in z.namelist():
                        out[f"{rel}:{m}"] = z.read(m)
            else:
                with open(path, "rb") as fh:
                    out[rel] = fh.read()
    return out


def test_write_3dmatch_suite_equals_jax(tmp_path):
    kw = dict(n_pairs=3, n_scene=600, seed=5)
    jinfo = jsyn.write_3dmatch_suite(str(tmp_path / "j"), "3DMatch", **kw)
    tinfo = tsyn.write_3dmatch_suite(str(tmp_path / "t"), "3DMatch", **kw)
    assert os.path.relpath(tinfo, tmp_path / "t") \
        == os.path.relpath(jinfo, tmp_path / "j")
    jb, tb = _tree_bytes(tmp_path / "j"), _tree_bytes(tmp_path / "t")
    assert len(tb) == 3 * 2 + 5 and jb == tb
    jds = J3D(jinfo, str(tmp_path / "j"))
    tds = ThreeDMatchDataset(tinfo, str(tmp_path / "t"))
    assert len(tds) == len(jds) == 3
    for i in range(3):
        jp, tp = jds[i], tds[i]
        for f in ("src", "tgt", "flow_gt", "overlap", "rot", "trans",
                  "correspondences"):
            assert np.array_equal(getattr(tp, f), getattr(jp, f)), f
        assert tp.name == jp.name and tp.overlap.sum() > 50


def test_write_3dmatch_train_suite_equals_jax(tmp_path):
    kw = dict(n_pairs=3, n_scene=600, noise=0.002, seed=9)
    jp = jsyn.write_3dmatch_train_suite(str(tmp_path / "j"), "train-3dm-b",
                                        **kw)
    tp = tsyn.write_3dmatch_train_suite(str(tmp_path / "t"), "train-3dm-b",
                                        **kw)
    assert [os.path.relpath(p, tmp_path / "t") for p in tp] \
        == [os.path.relpath(p, tmp_path / "j") for p in jp]
    jb, tb = _tree_bytes(tmp_path / "j"), _tree_bytes(tmp_path / "t")
    assert len(tb) == 3 * 7 and jb == tb
    jds = JDS(str(tmp_path / "j"), "train-3dm-b")
    tds = FourDMatchDataset(str(tmp_path / "t"), "train-3dm-b")
    for i in range(3):
        assert np.array_equal(tds[i].src, jds[i].src)
        assert np.array_equal(tds[i].correspondences,
                              jds[i].correspondences)


def test_dataset_augment_and_limits(tmp_path):
    """The augmenting reader draws the same stream as the JAX one, and the
    max_points cut too."""
    info = tsyn.write_3dmatch_suite(str(tmp_path), "3DMatch", n_pairs=2,
                                    n_scene=600, seed=3)
    kw = dict(max_points=300, augment=True, seed=4)
    jds, tds = J3D(info, str(tmp_path), **kw), ThreeDMatchDataset(
        info, str(tmp_path), **kw)
    for i in range(2):
        jp, tp = jds[i], tds[i]
        assert len(tp.src) == 300
        for f in ("src", "tgt", "rot", "trans", "flow_gt", "overlap"):
            assert np.array_equal(getattr(tp, f), getattr(jp, f)), f


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("3dm")
    info = tsyn.write_3dmatch_suite(str(tmp / "split"), "3DMatch",
                                    n_pairs=2, n_scene=500, noise=0.001,
                                    seed=7)
    jcfg, tcfg = landmark_cfg(JMODS), landmark_cfg(TMODS)
    jparams = jl.init_landmark_model(jax.random.key(0), jcfg)
    tparams = tdp.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    "cpu")
    jds = J3D(info, str(tmp / "split"))
    jsum = jev.run_eval_3dmatch(jcfg, jparams, jds, jds.infos["gt_cov"],
                                log_dir=str(tmp / "jax"), ransac_iters=200)
    tds = ThreeDMatchDataset(info, str(tmp / "split"))
    tsum = tev.run_eval_3dmatch(tcfg, tparams, tds, tds.infos["gt_cov"],
                                log_dir=str(tmp / "torch"), ransac_iters=200,
                                device="cpu")
    rows = {}
    for tag in ("jax", "torch"):
        path = tmp / tag / "3DMatch.pairs.jsonl"
        rows[tag] = [json.loads(l) for l in path.read_text().splitlines()]
    return dict(tmp=tmp, jsum=jsum, tsum=tsum, **rows)


def test_run_eval_3dmatch_matches_jax(runs):
    jrows, trows = runs["jax"], runs["torch"]
    assert len(trows) == len(jrows) == 2
    assert [set(r) for r in trows] == [set(r) for r in jrows]
    for t, j in zip(trows, jrows):
        assert t["name"] == j["name"]
        assert t["n_matches"] == j["n_matches"] > 0
        assert t["recall_ok"] == j["recall_ok"]
        assert t["ransac_inliers"] == j["ransac_inliers"]
        assert abs(t["IR"] - j["IR"]) < 1e-6
        for k in ("trans_err", "RTE", "RRE_deg"):
            assert abs(t[k] - j[k]) <= 1e-4 * max(abs(j[k]), 1e-3), \
                (k, t[k], j[k])
    jsum, tsum = runs["jsum"], runs["tsum"]
    assert set(jsum) <= set(tsum)
    assert tsum["value"] == jsum["value"] and 0.0 <= tsum["value"] <= 1.0
    assert tsum["pairs"] == 2 and tsum["ransac_s"] > 0
    log = (runs["tmp"] / "torch" / "3DMatch.log").read_text().splitlines()
    assert json.loads(log[-1])["metric"] == "threedmatch_recall"
    assert "registration_recall" in log[0]


def test_main_flags(runs, tmp_path, monkeypatch):
    """main(): --limit, --no-reject-outliers and --ransac-* reach
    run_eval_3dmatch, --visualize too, which writes a correspondence PLY
    (an edge a match) and PNG a pair under <log-dir>/vis/."""
    seen = {}

    def fake(lcfg, params, ds, gt_covs, **kw):
        seen.update(kw, n=len(ds), covs=len(gt_covs),
                    reject=lcfg.reject_outliers)
        return {}

    real = tev.run_eval_3dmatch
    monkeypatch.setattr(tev, "run_eval_3dmatch", fake)
    base = str(runs["tmp"] / "split")
    tev.main(["--config", "config/LNDP.yaml", "--info",
              f"{base}/3DMatch/test_info.npz", "--base-dir", base,
              "--limit", "1", "--no-reject-outliers", "--ransac-iters",
              "50", "--ransac-thr", "0.1", "--device", "cpu",
              "--log-dir", str(tmp_path)])
    assert seen["n"] == seen["covs"] == 1 and not seen["reject"]
    assert (seen["ransac_iters"], seen["ransac_thr"]) == (50, 0.1)
    assert seen["visualize"] is False
    tev.main(["--config", "config/LNDP.yaml", "--info",
              f"{base}/3DMatch/test_info.npz", "--base-dir", base,
              "--visualize", "--device", "cpu"])
    assert seen["visualize"] is True
    tds = ThreeDMatchDataset(f"{base}/3DMatch/test_info.npz", base)
    tds.infos = {k: v[:1] for k, v in tds.infos.items()}
    tparams = tdp.params_from_numpy(jax.tree.map(np.asarray,
                                                 jl.init_landmark_model(
                                                     jax.random.key(0),
                                                     landmark_cfg(JMODS))),
                                    "cpu")
    real(landmark_cfg(TMODS), tparams, tds, tds.infos["gt_cov"],
         log_dir=str(tmp_path / "vis"), ransac_iters=20, visualize=True,
         device="cpu")
    row = json.loads((tmp_path / "vis" / "3DMatch.pairs.jsonl").read_text())
    base = tmp_path / "vis" / "vis" / os.path.basename(tds[0].name)
    ply = Path(str(base) + "_corr.ply").read_text()
    assert f"element edge {int(row['n_matches'])}\n" in ply
    assert Path(str(base) + "_corr.png").stat().st_size > 0
