"""The port's LNDP evaluation (``cli/eval_supervised.py``) against the JAX
package's, on the CPU: two fabricated pairs of 250 points (the split of
``tests/test_eval_supervised.py``) through ``run_eval`` at its tiny
configuration (FD 96, NeCo 48 wide with 2 layers, m = 2, width 16, 10
iterations), the landmark model's weights from the JAX init (converted with
``params_from_numpy``) and each pair's initial pyramid the JAX sweep's
(through ``eval_supervised.initial_params``).

Tolerances: the pair names, ``n_matches_pre`` and ``n_landmarks`` equal;
``IR`` / ``IR_pre`` / ``NRFMR`` within 1e-6 (the matches are no near-ties at
these weights: ``n_matches_pre`` equal is checked first); the EPEs within
0.1 cm, the criterion of the no-learned CLI's parity test. The host-side
helpers (the flow interpolator, the ground-truth inlier filter) are equal
bit for bit.
"""
import json
import sys

import numpy as np
import pytest

import jax
import torch

from deformationpyramid_tpu.cli import eval_supervised as jev
from deformationpyramid_tpu.data.fourdmatch import FourDMatchDataset as JDS
from deformationpyramid_tpu.match import kpconv as jkp
from deformationpyramid_tpu.match import landmark as jl
from deformationpyramid_tpu.match import matching as jm
from deformationpyramid_tpu.match import outlier_rejection as jneco
from deformationpyramid_tpu.match import pipeline as jpipe
from deformationpyramid_tpu.match import position_encoding as jpe
from deformationpyramid_tpu.match import transformer as jtr
from deformationpyramid_tpu.models import pyramid as jpyr
from deformationpyramid_tpu.solve import registration as jreg
from deformationpyramid_tpu.utils.config import AttrDict as JAttrDict
import deformationpyramid_tpu_torch as tdp
from deformationpyramid_tpu_torch.cli import eval_supervised as tev
from deformationpyramid_tpu_torch.data.fourdmatch import FourDMatchDataset
from deformationpyramid_tpu_torch.match import kpconv as tkp
from deformationpyramid_tpu_torch.match import landmark as tl
from deformationpyramid_tpu_torch.match import matching as tm
from deformationpyramid_tpu_torch.match import outlier_rejection as tneco
from deformationpyramid_tpu_torch.match import pipeline as tpipe
from deformationpyramid_tpu_torch.match import position_encoding as tpe
from deformationpyramid_tpu_torch.match import transformer as ttr
from deformationpyramid_tpu_torch.utils.config import AttrDict

sys.path.insert(0, "tests")
from test_eval_cli import write_synthetic_4dmatch  # noqa: E402

FD = 96
SPLIT = "4DMatch-F"
PYR = dict(m=2, k0=-3, depth=2, width=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def landmark_cfg(mods):
    """tests/test_eval_supervised.py's landmark model in either package."""
    L, P, T, M, PE, K, N = mods
    kcfg = K.KPConvConfig(first_subsampling_dl=0.05, first_feats_dim=32,
                          coarse_feature_dim=FD, fine_feature_dim=24)
    vol = PE.VolPEConfig(feature_dim=FD, vol_origin=(-2.0, -2.0, -2.0))
    return L.LandmarkConfig(
        matcher=P.MatcherConfig(
            kpfcn=kcfg,
            transformer=T.TransformerConfig(
                feature_dim=FD, n_head=4, vol=vol,
                matching=M.MatchingConfig(feature_dim=FD)),
            matching=M.MatchingConfig(feature_dim=FD), max_matches=32),
        neco=N.NeCoConfig(feature_dim=48, n_head=4, num_layers=2),
        inlier_thr=0.0, reject_outliers=False)


JMODS = (jl, jpipe, jtr, jm, jpe, jkp, jneco)
TMODS = (tl, tpipe, ttr, tm, tpe, tkp, tneco)


def _rows(path):
    return [json.loads(l) for l in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """One JAX sweep and one port sweep of the same split and weights."""
    tmp = tmp_path_factory.mktemp("sup")
    root = str(tmp / "split")
    write_synthetic_4dmatch(root, SPLIT, n_pairs=2, n_pts=250)
    jcfg = landmark_cfg(JMODS)
    jscfg = jreg.SolverConfig(pyramid=jpyr.NDPConfig(**PYR), iters=10,
                              samples=64, use_pallas=False)
    jparams = jl.init_landmark_model(jax.random.key(0), jcfg)
    jev.run_eval(JAttrDict({"data_root": root}), jcfg, jparams, jscfg,
                 [SPLIT], log_dir=str(tmp / "jax"))

    # the JAX sweep's initial pyramids, pair by pair (its key chain)
    key, inits = jax.random.key(0), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        k_init = jax.random.split(sub, 3)[0]
        inits.append(jax.tree.map(
            np.asarray, jpyr.init_pyramid_params(k_init, jscfg.pyramid)))
    tcfg = landmark_cfg(TMODS)
    tscfg = tdp.SolverConfig(pyramid=tdp.NDPConfig(**PYR), iters=10,
                             samples=64)
    tparams = tdp.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    "cpu")
    calls = []

    def jax_init(scfg, seed, device=None):
        calls.append(seed)
        return tdp.params_from_numpy(inits[len(calls) - 1], device)

    mp = pytest.MonkeyPatch()
    mp.setattr(tev, "initial_params", jax_init)
    cfg = AttrDict({"data_root": root})
    report = tev.run_eval(cfg, tcfg, tparams, tscfg, [SPLIT],
                          log_dir=str(tmp / "torch"), device="cpu")
    mp.undo()
    return dict(tmp=tmp, root=root, cfg=cfg, tcfg=tcfg, tscfg=tscfg,
                tparams=tparams, report=report,
                jrows=_rows(tmp / "jax" / f"{SPLIT}.pairs.jsonl"),
                trows=_rows(tmp / "torch" / f"{SPLIT}.pairs.jsonl"))


def test_host_helpers_equal_jax_bit_for_bit(sweep):
    jds, tds = JDS(sweep["root"], SPLIT), FourDMatchDataset(sweep["root"],
                                                            SPLIT)
    rng = np.random.default_rng(3)
    for i in range(2):
        jp, tp = jds[i], tds[i]
        q = (tp.src[rng.permutation(len(tp.src))[:40]]
             + rng.normal(scale=0.01, size=(40, 3))).astype(np.float32)
        flow = tev.make_flow_interp(tp)(q)
        assert np.array_equal(flow, jev.make_flow_interp(jp)(q))
        assert np.array_equal(tev.interp_flow(q, tp), jev.interp_flow(q, jp))
        # the JAX filter (a closure of run_eval) written out on its interp
        v6 = np.concatenate([q, q + flow + rng.normal(
            scale=0.03, size=(40, 3)).astype(np.float32)], 1)
        v6[:, 3:] = (tp.rot @ v6[:, 3:].T + tp.trans).T
        mask = rng.random(40) > 0.2
        warped = (jp.rot @ (q + jev.interp_flow(q, jp)).T + jp.trans).T
        want = mask & (np.sum((warped - v6[:, 3:]) ** 2, 1) < 0.04 ** 2)
        got = tev.gt_inlier_keep(v6, mask, tp)
        assert np.array_equal(got, want)
        assert 0 < got.sum() < mask.sum()


def test_run_eval_matches_jax(sweep):
    jrows, trows = sweep["jrows"], sweep["trows"]
    assert [r["name"] for r in trows] == [r["name"] for r in jrows]
    assert len(trows) == 2
    assert set(trows[0]) == set(jrows[0])
    for t, j in zip(trows, jrows):
        assert t["n_matches_pre"] == j["n_matches_pre"] > 0
        assert t["n_landmarks"] == j["n_landmarks"]
        for k in ("IR", "IR_pre", "NRFMR"):
            assert abs(t[k] - j[k]) < 1e-6, (k, t[k], j[k])
        for k in tev.METRIC_KEYS:
            if k.endswith("epe"):
                assert abs(t[k] - j[k]) < 0.1, (k, t[k], j[k])
        # rejection off: the filter is the identity
        assert t["IR"] == pytest.approx(t["IR_pre"])
    rep = sweep["report"][SPLIT]
    assert rep["pairs"] == 2
    assert all(len(v) == PYR["m"] and all(1 <= i <= 10 for i in v)
               for v in rep["iters"].values())
    summary = json.loads(rep["summary"])
    assert summary["metric"] == "lndp_suite" and summary["pairs"] == 2
    log = (sweep["tmp"] / "torch" / f"{SPLIT}.log").read_text()
    assert "full-epe" in log and "IR" in log and "NRFMR" in log


def test_resume_solves_nothing_and_reproduces(sweep, capsys):
    log_dir = sweep["tmp"] / "torch"
    rep = tev.run_eval(sweep["cfg"], sweep["tcfg"], sweep["tparams"],
                       sweep["tscfg"], [SPLIT], log_dir=str(log_dir),
                       resume=True, device="cpu")
    assert "[resume] 2 pairs already done" in capsys.readouterr().out
    assert rep[SPLIT]["pairs"] == 0 and not rep[SPLIT]["iters"]
    assert rep[SPLIT]["scores"] == sweep["report"][SPLIT]["scores"]
    lines = [l for l in (log_dir / f"{SPLIT}.log").read_text().splitlines()
             if "full-epe" in l and not l.startswith("{")]
    assert len(lines) == 2 and lines[0] == lines[1]
    assert len(_rows(log_dir / f"{SPLIT}.pairs.jsonl")) == 2


def test_stage_timers_oracle_filter_and_visualize(sweep, monkeypatch):
    tmp = sweep["tmp"]
    args = (sweep["cfg"], sweep["tcfg"], sweep["tparams"], sweep["tscfg"],
            [SPLIT])
    tev.run_eval(*args, log_dir=str(tmp / "st"), stage_timers=True,
                 device="cpu")
    for row in _rows(tmp / "st" / f"{SPLIT}.pairs.jsonl"):
        for k in ("matcher", "neco", "solve", "metrics", "rtt_pre",
                  "rtt_post"):
            assert k in row["stages_ms"], k
        assert row["stages_ms"]["rtt_pre"] == 0.0   # no device to probe
    summary = next(json.loads(l) for l in
                   (tmp / "st" / f"{SPLIT}.log").read_text().splitlines()
                   if l.startswith("{"))
    assert summary["stages_ms"]["solve"]["n"] == 2
    tev.run_eval(*args, log_dir=str(tmp / "or"), oracle_filter=True,
                 stage_timers=True, device="cpu")
    rows = _rows(tmp / "or" / f"{SPLIT}.pairs.jsonl")
    for row in rows:
        assert "oracle" in row["stages_ms"] and "neco" not in row["stages_ms"]
        assert row["n_landmarks"] <= row["n_matches_pre"]
        if row["n_landmarks"] > 0:
            assert row["IR"] == pytest.approx(1.0)
    # --visualize: each pair with landmarks gets a correspondence PLY (one
    # edge a landmark) and PNG under <log_dir>/vis/
    tev.run_eval(*args, log_dir=str(tmp / "vis"), visualize=True,
                 device="cpu")
    for row in _rows(tmp / "vis" / f"{SPLIT}.pairs.jsonl"):
        base = tmp / "vis" / "vis" / row["name"].replace("/", "_")
        if row["n_landmarks"] == 0:
            continue
        ply = (base.parent / (base.name + "_corr.ply")).read_text()
        assert f"element edge {int(row['n_landmarks'])}\n" in ply
        assert (base.parent / (base.name + "_corr.png")).stat().st_size > 0
    seen = {}
    monkeypatch.setattr(tev, "run_eval",
                        lambda *a, **kw: seen.update(kw) or {})
    tev.main(["--config", "config/LNDP.yaml", "--visualize", "--device",
              "cpu"])
    assert seen["visualize"] is True


def test_configs_from_the_yaml():
    """config/LNDP.yaml -> the published landmark model, uncapped, on kernel
    C7's route, and the LNDP solver (C5 on the card); the flags override."""
    from deformationpyramid_tpu_torch.utils.config import load_config

    cfg = load_config("config/LNDP.yaml")
    lcfg = tev.landmark_config(cfg)
    assert lcfg.matcher.max_matches is None and lcfg.reject_outliers
    assert lcfg.inlier_thr == 0.3
    assert lcfg.matcher.kpfcn.coarse_feature_dim == 528
    assert lcfg.matcher.transformer.attention_impl == "flash"   # C7
    off = tev.landmark_config(cfg, False, 0.5, 256)
    assert (off.reject_outliers, off.inlier_thr,
            off.matcher.max_matches) == (False, 0.5, 256)
    scfg = tev.solver_config(cfg, "cuda")
    assert (scfg.pyramid.m, scfg.w_cd, scfg.use_fused_iteration,
            scfg.use_fused_ldmk) == (10, 0.0, True, True)
    assert tev.solver_config(cfg, "cpu", w_cd=1.0).w_cd == 1.0


def test_bench_lndp_torch_line(monkeypatch, capsys, tmp_path):
    """bench_lndp_torch.py reads each repetition's lndp_suite line from the
    split's log and prints the median's pairs/s with the best per-pair
    time; run_eval stubbed."""
    import bench_lndp_torch as bench

    rates = iter([0.5, 0.25, 1.0])

    def fake_run_eval(cfg, lcfg, params, scfg, splits, batch_limit=None,
                      log_dir=None, device=None, **kw):
        rate = next(rates)
        with open(f"{log_dir}/{splits[0]}.log", "w") as f:
            f.write("24/24 pairs: full-epe: 1.0\n")
            f.write(json.dumps({
                "metric": "lndp_suite", "split": splits[0],
                "pairs": batch_limit, "total_s": batch_limit / rate,
                "pairs_per_sec": rate,
                "per_pair_s": {"best": 1 / rate - 0.1}}) + "\n")
        return {}

    monkeypatch.setattr(tev, "run_eval", fake_run_eval)
    monkeypatch.setattr(bench, "card_line", lambda dev: "CPU, none")
    bench.main(["--limit", "4", "--reps", "3", "--device", "cpu",
                "--weights", str(tmp_path / "missing.npz")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "lndp_pairs_per_sec"
    assert line["value"] == 0.5 and line["pairs"] == 4
    assert line["per_pair_best_s"] == pytest.approx(0.9)
    assert line["weights"] == "random" and line["reps"] == 3
    assert line["card"] == "CPU, none" and "vs_baseline" not in line
