"""The port's own spans and counters (``utils/timers.py`` ``span``,
``count``), the per-level hook of the solve, and the places that the
benchmark replaces by name, on the CPU at tiny widths.

A span is a host range ``dp::<layer>`` and a counter moves only while
``torch.profiler`` records; with the profiler on or off every output is
bit-equal. Nothing here imports JAX: these are properties of the port.
"""
import contextlib
import json

import numpy as np
import pytest
import torch

from deformationpyramid_tpu_torch.data import collate as tcol
from deformationpyramid_tpu_torch.data.correspondence_utils import (
    blend_scene_flow, mutual_nn_correspondence)
from deformationpyramid_tpu_torch.data.synthetic import make_pair
from deformationpyramid_tpu_torch.match import attention as tatt
from deformationpyramid_tpu_torch.match import backbone as tbb
from deformationpyramid_tpu_torch.match import kpconv as tkp
from deformationpyramid_tpu_torch.match import landmark as tl
from deformationpyramid_tpu_torch.match import matching as tm
from deformationpyramid_tpu_torch.match import outlier_rejection as tneco
from deformationpyramid_tpu_torch.match import pipeline as tpipe
from deformationpyramid_tpu_torch.match import position_encoding as tpe
from deformationpyramid_tpu_torch.match import transformer as ttr
from deformationpyramid_tpu_torch.models import pyramid as tpyr
from deformationpyramid_tpu_torch.models.pyramid import tree_leaves
from deformationpyramid_tpu_torch.ops import fused_iteration as tfi
from deformationpyramid_tpu_torch.ops.fused_iteration import SYNC_EVERY
from deformationpyramid_tpu_torch.solve import registration as treg
from deformationpyramid_tpu_torch.solve.loop import LoopConfig
from deformationpyramid_tpu_torch.train import trainer as ttrain
from deformationpyramid_tpu_torch.utils import timers

# LNDP's solver half (landmarks alone, C5's plain twin on the CPU) at
# config/LNDP.yaml's k0; ``iters`` a multiple of SYNC_EVERY, so that every
# level issues a multiple of it
SOLVE = treg.SolverConfig(
    pyramid=tpyr.NDPConfig(m=3, k0=-8, depth=3, width=32,
                           rotation_format="axis_angle", motion="SE3"),
    iters=4 * SYNC_EVERY, lr=0.01, max_break_count=15,
    break_threshold_ratio=0.001, samples=200, use_fused_iteration=True,
    use_fused_ldmk=True)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    timers.reset_counters()
    try:
        yield
    finally:
        torch.set_num_threads(prev)
        timers.reset_counters()


def _solve_inputs(seed=4, n=220, n_ldmk=48):
    src, tgt, _ = make_pair(n=n, seed=seed, deform=0.12)
    rng = np.random.default_rng(seed)
    li = rng.permutation(n)[:n_ldmk]
    t_l = tgt[li] + rng.standard_normal((n_ldmk, 3)) * 0.002
    return dict(src=torch.from_numpy(src), tgt=torch.from_numpy(tgt),
                src_ldmk=torch.from_numpy(src[li]),
                tgt_ldmk=torch.from_numpy(t_l.astype(np.float32)),
                ldmk_valid=torch.arange(n_ldmk) < n_ldmk - 8)


def _solve(on_level=None):
    x = _solve_inputs()
    return treg.register_pair(11, x["src"], x["tgt"], SOLVE,
                              src_ldmk=x["src_ldmk"], tgt_ldmk=x["tgt_ldmk"],
                              ldmk_valid=x["ldmk_valid"], on_level=on_level)


@contextlib.contextmanager
def _profiled(ranges: list):
    """Profile the block on the CPU; on exit, put the ``dp::`` ranges of
    the trace into ``ranges`` as (name, start, end), in order of start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        yield
    evs = prof.profiler.kineto_results.events()
    ranges.extend(sorted(
        ((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
         for e in evs if e.name().startswith("dp::")), key=lambda r: r[1]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def test_span_and_count_are_off_without_the_profiler():
    assert not torch.autograd._profiler_enabled()
    assert timers.span("dp::solve") is timers.span("dp::landmark")
    assert isinstance(timers.span("dp::solve"), contextlib.nullcontext)
    assert not timers.recording()
    _solve()
    timers.count("early_stop.noops", 3)
    assert timers.counters() == {}


def _noops(iters) -> np.ndarray:
    """The no-ops of levels that applied ``iters``: the loop reads its
    stop flag every SYNC_EVERY calls, so it issues the next multiple of
    SYNC_EVERY (at most ``SOLVE.iters``) and the rest apply nothing."""
    issued = np.minimum(-(-iters // SYNC_EVERY) * SYNC_EVERY, SOLVE.iters)
    return issued - iters


def test_solve_span_and_launch_counter():
    """One ``dp::solve`` range; every level's loop counts as no-ops the
    calls it issued after its stop, fewer than SYNC_EVERY (read level by
    level through the level hook)."""
    noops = []

    def on_level(lvl, *_):
        noops.append(timers.counters().get("early_stop.noops", 0))

    ranges = []
    with _profiled(ranges):
        _, stats = _solve(on_level)
    assert [r[0] for r in ranges] == ["dp::solve"]
    per_level = np.diff([0] + noops)
    iters = stats["iters"].numpy()
    assert (iters < SOLVE.iters).any()      # some level stopped early
    assert (per_level == _noops(iters)).all()
    assert ((0 <= per_level) & (per_level < SYNC_EVERY)).all()
    assert timers.counters() == {"early_stop.noops": per_level.sum()}


def test_outputs_bit_equal_with_the_profiler_on_and_off():
    off_w, off_s = _solve()
    with _profiled([]):
        on_w, on_s = _solve()
    assert torch.equal(off_w, on_w)
    assert all(torch.equal(off_s[k], on_s[k]) for k in off_s)


def test_trace_writes_the_counters(tmp_path):
    timers.count("stale", 1)        # off: not counted
    with timers.trace(str(tmp_path / "prof")):
        timers.count("stale", 5)
        _, stats = _solve()
    got = json.loads((tmp_path / "prof" / "counters.json").read_text())
    assert got == {"stale": 5,
                   "early_stop.noops": int(_noops(stats["iters"].numpy())
                                           .sum())}
    with timers.trace(str(tmp_path / "again")):
        pass
    assert json.loads(
        (tmp_path / "again" / "counters.json").read_text()) == {}


def test_level_hook_sees_every_level_in_order():
    seen = []

    def on_level(lvl, params_in, pts_in, out):
        seen.append((lvl, params_in, pts_in, out))

    plain_w, plain_s = _solve()
    hooked_w, hooked_s = _solve(on_level)
    assert torch.equal(plain_w, hooked_w)
    assert all(torch.equal(plain_s[k], hooked_s[k]) for k in plain_s)
    assert [s[0] for s in seen] == list(range(SOLVE.pyramid.m))
    for lvl, (_, params_in, pts_in, (p_out, pts_out, stats)) in \
            enumerate(seen):
        assert stats["iters"] == hooked_s["iters"][lvl]
        assert set(params_in) == set(p_out)
        if lvl + 1 < len(seen):
            assert seen[lvl + 1][2] is pts_out      # the next level's input


# ---------------- the landmark model and the trainer ----------------

def _landmark_cfg(attention_impl="xla"):
    kp = tkp.KPConvConfig(first_subsampling_dl=0.1, first_feats_dim=8,
                          coarse_feature_dim=24, fine_feature_dim=8)
    vol = tpe.VolPEConfig(feature_dim=24, vol_origin=(-2.0, -2.0, -2.0))
    mc = tm.MatchingConfig(feature_dim=24)
    tr = ttr.TransformerConfig(feature_dim=24, n_head=2, vol=vol,
                               matching=mc, attention_impl=attention_impl)
    return tl.LandmarkConfig(
        matcher=tpipe.MatcherConfig(kpfcn=kp, transformer=tr, matching=mc,
                                    max_matches=16),
        neco=tneco.NeCoConfig(feature_dim=12, n_head=2, num_layers=1))


@pytest.fixture(scope="module")
def tiny():
    """A narrow landmark model and one pair's batch, as the trainer's CPU
    tests build them, from the port alone."""
    cfg = _landmark_cfg()
    params = tl.init_landmark_model(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    src, tgt, flow = make_pair(n=120, seed=1, deform=0.05)
    kp = cfg.matcher.kpfcn
    arch = tbb.KPFCN_ARCHITECTURE
    limits = tcol.calibrate_neighborhood_limits([(src, tgt)], kp, arch)
    pyr = tcol.build_pair_pyramid(src, tgt, kp, arch, limits)
    cl = cfg.matcher.coarse_level
    s_len, t_len = int(pyr.src_lengths[cl]), int(pyr.tgt_lengths[cl])
    coarse = pyr.points[cl]
    c_src, c_tgt = coarse[:s_len], coarse[s_len:s_len + t_len]
    c_flow = blend_scene_flow(c_src, src, flow)
    corr = mutual_nn_correspondence(c_src + c_flow, c_tgt, search_radius=0.15)
    cap = max(s_len, t_len)
    match_gt = np.zeros((cap, 2), np.int64)
    match_gt_valid = np.zeros((cap,), bool)
    match_gt[:len(corr)] = corr[:cap]
    match_gt_valid[:len(corr)] = True
    coarse_flow = np.zeros((cap, 3), np.float32)
    coarse_flow[:s_len] = c_flow
    return dict(cfg=cfg, params=params, pyr=pyr, s_len=s_len, t_len=t_len,
                cap=cap, step_args=(
                    torch.from_numpy(match_gt),
                    torch.from_numpy(match_gt_valid),
                    torch.from_numpy(coarse_flow), torch.eye(3),
                    torch.zeros(3, 1)))


def _landmarks(tiny, cfg=None):
    pyrd = tcol.pyramid_to_device(tiny["pyr"], "cpu")
    return tl.landmark_inference(tiny["params"], pyrd, tiny["s_len"],
                                 tiny["t_len"], cfg or tiny["cfg"],
                                 s_cap=tiny["cap"], t_cap=tiny["cap"])


def test_landmark_spans_nest(tiny):
    ranges = []
    with _profiled(ranges):
        on = _landmarks(tiny)
    off = _landmarks(tiny)
    names = {r[0] for r in ranges}
    assert names == {"dp::collate.to_device", "dp::landmark",
                     "dp::landmark.matching", "dp::landmark.neco"}
    (outer,) = _named(ranges, "dp::landmark")
    (to_device,) = _named(ranges, "dp::collate.to_device")
    (matching,) = _named(ranges, "dp::landmark.matching")
    (neco,) = _named(ranges, "dp::landmark.neco")
    assert to_device[2] <= outer[1]
    assert _inside(matching, outer) and _inside(neco, outer)
    assert matching[2] <= neco[1]
    for k in ("ldmk_s", "ldmk_t", "ldmk_valid", "neco_confidence",
              "conf_matrix_pred"):
        assert torch.equal(on[k], off[k])


def _train_step(tiny, opt):
    step = ttrain.make_matcher_train_step(tiny["cfg"], opt, s_cap=tiny["cap"],
                                          t_cap=tiny["cap"])
    params = tiny["params"]["matcher"]
    pyrd = tcol.pyramid_to_device(tiny["pyr"], "cpu")
    state = opt.init(params)
    return step(params, state, pyrd, torch.tensor(tiny["s_len"]),
                torch.tensor(tiny["t_len"]), *tiny["step_args"])


def _adam():
    return ttrain.make_optimizer(ttrain.TrainConfig(optimizer="Adam",
                                                    lr=1e-3), 10)


def test_train_step_spans_and_bit_equal_update(tiny):
    ranges = []
    with _profiled(ranges):
        on = _train_step(tiny, _adam())
    off = _train_step(tiny, _adam())
    (step,) = _named(ranges, "dp::train.step")
    (update,) = _named(ranges, "dp::train.update")
    assert _inside(update, step)
    (matching,) = _named(ranges, "dp::landmark.matching")
    assert _inside(matching, step) and matching[2] <= update[1]
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(on[0]), tree_leaves(off[0])))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(on[1]), tree_leaves(off[1])))
    assert torch.equal(on[2], off[2])


# ---------------- the names the benchmark replaces ----------------

def test_replaced_level_solver_sees_every_level(monkeypatch):
    inner, calls = treg._solve_level, []

    def solve_level(lvl_params, lvl, pts, *args, **kw):
        calls.append(lvl)
        return inner(lvl_params, lvl, pts, *args, **kw)

    monkeypatch.setattr(treg, "_solve_level", solve_level)
    _solve()
    assert calls == list(range(SOLVE.pyramid.m))


def test_replaced_attention_sees_every_call(tiny, monkeypatch):
    inner, calls = tatt.flash_attention, []

    def flash(*args, **kw):
        calls.append(1)
        return inner(*args, **kw)

    monkeypatch.setattr(tatt, "flash_attention", flash)
    ranges = []
    with _profiled(ranges):
        _landmarks(tiny, _landmark_cfg(attention_impl="flash"))
    assert calls and len(calls) == len(_named(ranges, "dp::attention"))


def test_replaced_optimizer_update_sees_every_step(tiny):
    opt, calls = _adam(), []
    inner = opt.update

    def update(*args, **kw):
        calls.append(1)
        return inner(*args, **kw)

    opt.update = update
    _train_step(tiny, opt)
    assert calls == [1]
