"""The port's no-learned evaluation CLI (``cli/eval_nolearned.py``) against
the JAX package's, on the CPU, on a 3-pair split fabricated by
``write_4dmatch_suite`` with a tiny yaml (m 3, width 32, 30 iterations).

Both CLIs subsample on the host from the same numpy stream and seed each
pair by the CRC of its file name; with the JAX init's weights handed to the
port (through ``initial_params``) the two ``.pairs.jsonl`` ledgers agree to
1e-3 in the clouds' units on every EPE (0.1 in the ledger's centimetres:
the tolerance of the solver's own parity tests, three levels of Adam in
float32) and to 2 points on the percentages (a cloud of ~300 points moves
them by 0.3 a point that crosses a threshold). At least one pair agrees
to 1e-4 on every metric.
"""
import dataclasses
import json
import os
import sys
import zlib

import numpy as np
import pytest

import jax
import torch
import yaml

from deformationpyramid_tpu.cli import eval_nolearned as jeval
from deformationpyramid_tpu.models import pyramid as jpyr
from deformationpyramid_tpu.utils.config import load_config as jload_config
from deformationpyramid_tpu_torch.cli import eval_nolearned as teval
from deformationpyramid_tpu_torch.data.synthetic import write_4dmatch_suite
from deformationpyramid_tpu_torch.models import pyramid as tpyr
from deformationpyramid_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(deformation_model="NDP", iters=30, lr=0.01, max_break_count=15,
            break_threshold_ratio=0.001, w_reg=0.0, samples=200, m=3, k0=-8,
            depth=3, width=32, motion_type="SE3",
            rotation_format="axis_angle", exp_dir="t", folder="tiny")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is as fast as many,
    and parallel test workers do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def split(tmp_path):
    root = str(tmp_path / "data")
    write_4dmatch_suite(root, "4DMatch-F", n_pairs=3,
                        size_clusters=(300, 1200), seed=0)
    return root


def _yaml(tmp_path, root, name="cfg.yaml", **over):
    path = tmp_path / name
    path.write_text(yaml.safe_dump(dict(TINY, data_root=root, **over)))
    return str(path)


def _rows(snap, split="4DMatch-F"):
    with open(os.path.join(snap, split + ".pairs.jsonl")) as f:
        return [json.loads(line) for line in f]


def _run(cfg, snap, *extra):
    return teval.main(["--config", cfg, "--splits", "4DMatch-F", "--device",
                       "cpu", "--log-dir", str(snap), *extra])


def test_prep_sample_and_pair_seed_match_the_jax_cli():
    pts = np.random.default_rng(0).standard_normal((500, 3)).astype(np.float32)
    mean = pts.mean(0)
    for k in (200, 800):
        a = teval._prep_sample(pts, mean, k, np.random.default_rng([3, 77]))
        b = jeval._prep_sample(pts, mean, k, np.random.default_rng([3, 77]))
        assert a.dtype == b.dtype and np.array_equal(a, b)
    name = "data/split/4DMatch-F/seq0/pair0007.npz"
    pid = zlib.crc32(os.path.basename(name).encode())   # the JAX CLI's lines
    assert teval.pair_id(name) == pid
    assert teval.pair_id("/elsewhere/pair0007.npz") == pid
    for seed in (0, 5):
        assert teval.pair_seed(pid, seed) == (pid + seed) & 0x7FFFFFFF
    assert teval.METRIC_KEYS == jeval.METRIC_KEYS


@pytest.mark.parametrize("path", [
    "config/NDP.yaml", "config/baselines/NSFP.yaml",
    "config/baselines/Nerfies.yaml", "config/baselines/Sinkhorn.yaml"])
def test_solver_from_config_matches_jax(path):
    """Every field the two packages' solver configs share is equal, the
    nested model configs included, and so is the flow scope."""
    full = os.path.join(REPO, path)
    jscfg, _, jscope = jeval.solver_from_config(jload_config(full))
    tscfg, run, tscope = teval.solver_from_config(load_config(full), "cpu")
    assert callable(run) and tscope == jscope
    assert type(tscfg).__name__ == type(jscfg).__name__

    def shared(t, j):
        for f in dataclasses.fields(t):
            if not hasattr(j, f.name):
                continue
            a, b = getattr(t, f.name), getattr(j, f.name)
            if dataclasses.is_dataclass(a):
                shared(a, b)
            else:
                assert a == b, (f.name, a, b)

    shared(tscfg, jscfg)
    if path.endswith("Nerfies.yaml"):
        # the yaml's band_width, depth and width are not read (as in JAX)
        assert (tscfg.net.m_bands, tscfg.net.depth, tscfg.net.width) \
            == (6, 7, 128)


def test_unknown_and_unported_models_raise(tmp_path, split, capsys):
    with pytest.raises(KeyError):
        teval.solver_from_config(load_config(
            _yaml(tmp_path, split, deformation_model="Nope")), "cpu")
    # ED is ported: it hands over to cli/eval_ed.py, which skips the pairs
    # that carry no depth maps (write_4dmatch_suite writes none)
    assert _run(_yaml(tmp_path, split, deformation_model="ED"),
                tmp_path / "s") == {}
    out = capsys.readouterr().out
    assert "delegating to cli.eval_ed" in out and "no pairs with depth" in out
    # --visualize renders each pair (utils/vis.py, matplotlib)
    _run(_yaml(tmp_path, split, iters=2), tmp_path / "v", "--limit", "2",
         "--visualize")
    assert sorted(p.name for p in (tmp_path / "v").glob("*.png")) == [
        "4DMatch-F-0001.png", "4DMatch-F-0002.png"]


def test_multi_host_raises(tmp_path, split, monkeypatch):
    """A JAX multi-process launch (JAX_NUM_PROCESSES > 1) without
    torchrun's world raises and names torchrun; the torchrun sweep itself
    is tests/test_torch_parallel.py's."""
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        _run(_yaml(tmp_path, split), tmp_path / "s")


def test_fused_iteration_defaults(monkeypatch):
    """yaml key > DP_FUSED_ITER > on when the device is CUDA (NDP); NSFP
    explicit only."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    monkeypatch.delenv("DP_FUSED_ITER", raising=False)
    assert teval._fused_iter_default({}, cpu) is None
    assert teval._fused_iter_default({}, cuda) is True
    assert teval._fused_iter_explicit({}) is None
    assert teval._fused_iter_default({"use_fused_iteration": False},
                                     cuda) is False
    monkeypatch.setenv("DP_FUSED_ITER", "1")
    assert teval._fused_iter_default({}, cpu) is True
    assert teval._fused_iter_explicit({}) is True
    assert teval._fused_iter_explicit({"use_fused_iteration": False}) is False
    monkeypatch.setenv("DP_FUSED_ITER", "0")
    assert teval._fused_iter_default({}, cuda) is False
    scfg, _, _ = teval.solver_from_config(
        {"deformation_model": "NSFP", "use_fused_iteration": True}, "cpu")
    assert scfg.use_fused_iteration is True


def test_cli_matches_the_jax_cli(tmp_path, split, monkeypatch):
    cfg = _yaml(tmp_path, split)
    monkeypatch.setattr(sys, "argv", [
        "x", "--config", cfg, "--splits", "4DMatch-F", "--log-dir",
        str(tmp_path / "jax")])
    jeval.main()

    jcfg = jeval.solver_from_config(jload_config(cfg))[0].pyramid

    def jax_init(model, scfg, seed, device=None):
        key = jax.random.fold_in(jax.random.key(0), np.int32(seed))
        return tpyr.params_from_numpy(jax.tree.map(
            np.asarray, jpyr.init_pyramid_params(key, jcfg)), device)

    monkeypatch.setattr(teval, "initial_params", jax_init)
    scores = _run(cfg, tmp_path / "torch")
    jrows, trows = _rows(tmp_path / "jax"), _rows(tmp_path / "torch")
    assert [r["name"] for r in trows] == [r["name"] for r in jrows]
    assert len(trows) == 3
    exact = 0
    for t, j in zip(trows, jrows):
        diff = {k: abs(t[k] - j[k]) for k in teval.METRIC_KEYS}
        for k, d in diff.items():
            assert d < (0.1 if k.endswith("epe") else 2.0), (k, t[k], j[k])
        exact += max(diff.values()) < 1e-4
    assert exact >= 1
    assert abs(scores["4DMatch-F"]["scores"]["full-epe"]
               - np.mean([r["full-epe"] for r in jrows])) < 0.05
    for name in ("4DMatch-F.done", "4DMatch-F.log", "provenance.json",
                 "cfg.yaml"):
        assert (tmp_path / "torch" / name).exists()


def test_resume_limit_and_seed(tmp_path, split, capsys):
    """--limit 2 then --resume solves the one pair left and ends with the
    rows and the score of an uninterrupted run, bit for bit; --resume on a
    finished split solves nothing and prints the same score line; another
    --seed changes the rows."""
    cfg = _yaml(tmp_path, split)
    fresh = _run(cfg, tmp_path / "fresh")
    line = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith(" 3/3")]
    part = _run(cfg, tmp_path / "res", "--limit", "2")
    assert len(_rows(tmp_path / "res")) == 2
    assert part["4DMatch-F"]["scores"] != fresh["4DMatch-F"]["scores"]
    resumed = _run(cfg, tmp_path / "res", "--resume")
    out = capsys.readouterr().out
    assert "[resume] 2 pairs already done" in out
    assert "[4DMatch-F] 1 pairs in" in out
    assert _rows(tmp_path / "res") == _rows(tmp_path / "fresh")
    for k, v in fresh["4DMatch-F"]["scores"].items():
        assert abs(resumed["4DMatch-F"]["scores"][k] - v) < 1e-9
    assert resumed["4DMatch-F"]["pairs"] == 1
    again = _run(cfg, tmp_path / "res", "--resume")
    out = capsys.readouterr().out
    assert "[resume] 3 pairs already done" in out and "pairs/s" not in out
    assert [l for l in out.splitlines() if l.startswith(" 3/3")] == line
    assert len(_rows(tmp_path / "res")) == 3
    assert again["4DMatch-F"]["pairs"] == 0 and not again["4DMatch-F"]["iters"]
    assert again["4DMatch-F"]["scores"] == resumed["4DMatch-F"]["scores"]
    _run(cfg, tmp_path / "seed", "--seed", "1")
    assert _rows(tmp_path / "seed")[0]["full-epe"] \
        != _rows(tmp_path / "fresh")[0]["full-epe"]


def test_fast_legacy_stream_and_host_metrics_agree(tmp_path, split):
    """The fast path, --host-metrics (numpy warp on the fetched weights:
    1e-4), and the legacy bucketed path in batches and as a stream (equal
    to each other bit for bit; against the fast path another subsample of
    the same pairs, so the mean EPE agrees to 25% only)."""
    cfg = _yaml(tmp_path, split)
    fast_run = _run(cfg, tmp_path / "fast")["4DMatch-F"]
    host_run = _run(cfg, tmp_path / "host", "--host-metrics")["4DMatch-F"]
    fast, host = fast_run["scores"], host_run["scores"]
    assert fast_run["iters"] == host_run["iters"]
    assert all(len(v) == 3 and all(1 <= i <= 30 for i in v)
               for v in fast_run["iters"].values())
    for k in teval.METRIC_KEYS:
        assert abs(fast[k] - host[k]) < 1e-4, k
    legacy = _run(cfg, tmp_path / "legacy", "--no-fast", "--batch", "2")
    stream = _run(cfg, tmp_path / "stream", "--no-fast", "--stream",
                  "--depth", "1")
    by_name = lambda snap: {r["name"]: r for r in _rows(snap)}
    assert by_name(tmp_path / "legacy") == by_name(tmp_path / "stream")
    assert len(by_name(tmp_path / "legacy")) == 3
    a, b = fast["full-epe"], legacy["4DMatch-F"]["scores"]["full-epe"]
    assert np.isfinite(list(stream["4DMatch-F"]["scores"].values())).all()
    assert legacy["4DMatch-F"]["iters"] == stream["4DMatch-F"]["iters"]
    assert abs(a - b) < 0.25 * max(a, b)


def test_trunc_chamfer_override(tmp_path, split):
    cfg = _yaml(tmp_path, split)
    base = _run(cfg, tmp_path / "a", "--limit", "1")
    trunc = _run(cfg, tmp_path / "b", "--limit", "1", "--trunc-chamfer",
                 "0.01")
    assert base["4DMatch-F"]["scores"]["full-epe"] \
        != trunc["4DMatch-F"]["scores"]["full-epe"]


@pytest.mark.parametrize("model,over,extra", [
    ("NDP", dict(rotation_format="quaternion"), []),
    ("NDP", dict(rotation_format="6D", motion_type="Sim3"), []),
    ("NDP", dict(motion_type="sflow"), []),
    ("NSFP", dict(iters=12, use_fused_iteration=True), []),
    ("NSFP", dict(iters=12), ["--no-fast", "--batch", "2"]),
    ("Nerfies", dict(iters=6), []),
    ("Sinkhorn", dict(Nsteps=3), []),
    ("Sinkhorn", dict(Nsteps=3), ["--stream"])])
def test_cli_runs_every_model(tmp_path, split, model, over, extra):
    """Every deformation model and NDP option through the CLI at a tiny
    size: 2 pairs, 12 finite metrics each, a ledger row and a .done line
    a pair."""
    cfg = _yaml(tmp_path, split, deformation_model=model, **over)
    scores = _run(cfg, tmp_path / "snap", "--limit", "2", *extra)
    got = scores["4DMatch-F"]
    assert set(got["scores"]) == set(teval.METRIC_KEYS) and got["pairs"] == 2
    assert np.isfinite(list(got["scores"].values())).all()
    n_counts = over.get("m", TINY["m"]) if model == "NDP" else 1
    assert all(len(v) == n_counts for v in got["iters"].values())
    rows = _rows(tmp_path / "snap")
    assert len(rows) == 2 and all(len(r) == 13 for r in rows)
    done = (tmp_path / "snap" / "4DMatch-F.done").read_text().split()
    assert sorted(done) == sorted(r["name"] for r in rows)


def test_missing_split_is_skipped(tmp_path, split, capsys):
    scores = teval.main(["--config", _yaml(tmp_path, split), "--splits",
                         "4DLoMatch-F", "--device", "cpu", "--log-dir",
                         str(tmp_path / "s")])
    assert scores == {} and "[skip] no data" in capsys.readouterr().out
