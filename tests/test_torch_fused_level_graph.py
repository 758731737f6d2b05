"""The chamfer-mode level loop as replays of a captured CUDA graph
(``ops/fused_iteration.py`` ``LevelGraphs``, ``_LevelGraph``).

On the CPU: the early stop's in-place book-keeping against the rebinding
one it replaced, over scripted losses, each state tensor keeping its
identity; the cache's key and its policy (first sight eager, second
capture, later replay, a failed capture eager, the LRU bound); the graph
path's plumbing with a fake graph whose replay calls the captured step
(bit-equal to the eager loop, nothing handed out aliasing the graph's
tensors, the counters, each kernel's launches counted at each replay and
not at the capture); ``run_fused_level`` on CPU tensors against a
frozen copy of the loop as it was before the graph, bit for bit;
``_level_step``'s one iteration called by hand against the loop, bit for
bit; and the loop reading no route from the environment.

Marked ``cuda`` (each skips without a card; the decision is taken in a
fixture): eager against capture and replay bit for bit on the card, at
the Sim3 + euler shape transfer's 6000 x 6000, SE3 + axis_angle at 2000
points with padded rows, a level that hits its cap of 20 iterations, a
landmark + chamfer level and the nonrigidity head at level 0; the
returned tensors unchanged after two more levels of the same key; the
counters by the third sight; each kernel's launches over three sights of
one key, its launches a call times the calls the level issued. On the
card run
``python -m pytest --noconftest tests/test_torch_fused_level_graph.py -m
cuda -q``.
"""
import os
import types

import pytest
import torch

from deformationpyramid_tpu_torch.models import pyramid as tpyr
from deformationpyramid_tpu_torch.ops import cuda_lib
from deformationpyramid_tpu_torch.ops import fused_iteration as tfi
from deformationpyramid_tpu_torch.solve.loop import LoopConfig
from deformationpyramid_tpu_torch.utils import timers

CFG = tpyr.NDPConfig(m=4, k0=-6, depth=3, width=64)
LEVEL = 1
COUNTERS = ("fused_level.blocks", "fused_level.graph_replays",
            "fused_level.graph_captures", "fused_level.graph_failures",
            "early_stop.noops")


class _Rebinding(tfi.EarlyStop):
    """The early stop's book-keeping as it was before it updated in place:
    every result a new tensor bound to the attribute."""

    def decide(self, loss):
        cfg = self.cfg
        halt = self.done | (self.it >= cfg.iters)
        run = ~halt
        small = loss < cfg.loss_eps
        plateau = torch.abs(self.loss_prev - loss) \
            < self.loss_prev * cfg.break_threshold_ratio
        self.counter = self.counter + (plateau & run).to(torch.int32)
        self.done = torch.where(
            run, small | (self.counter >= cfg.max_break_count), self.done)
        return halt, halt | self.done

    def advance(self, loss, halt, hold):
        self.loss_prev = torch.where(hold, self.loss_prev, loss)
        self.it = self.it + (~halt).to(torch.int32)
        self.applied = self.applied + (~hold).to(torch.float32)
        self.loss = torch.where(halt, self.loss, loss)


STATE = ("loss", "loss_prev", "counter", "done", "it", "applied")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The loops run hundreds of tiny torch ops: one intra-op thread a
    worker, not a pool that contends with the other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _plateau(n):
    return [1.0] + [1.0 - 1e-5 * k for k in range(1, n)]


@pytest.mark.parametrize("losses,cfg", [
    # a plateau: the counter reaches max_break_count
    (_plateau(12), LoopConfig(iters=50, max_break_count=4)),
    # a loss under loss_eps stops at once
    ([0.5, 0.25, 5e-5, 0.1, 0.1], LoopConfig(iters=50)),
    # the cap: no iteration applies past iters
    ([1.0 / (k + 1) for k in range(9)], LoopConfig(iters=5)),
    # plateaus apart from each other add up to max_break_count
    ([1.0, 0.9, 0.8, 0.8, 0.7, 0.6, 0.6, 0.5],
     LoopConfig(iters=50, max_break_count=2)),
])
def test_early_stop_in_place_matches_rebinding(losses, cfg):
    """``decide`` / ``advance`` give the values of the rebinding version
    at every step, and each state tensor keeps its identity and storage
    across calls (C4 and C5 read them through pointers, a graph's replay
    reads what the last one wrote)."""
    cpu = torch.device("cpu")
    new, old = tfi.EarlyStop(cfg, cpu), _Rebinding(cfg, cpu)
    ids = [(id(getattr(new, k)), getattr(new, k).data_ptr()) for k in STATE]
    for k, value in enumerate(losses):
        loss = torch.tensor(value, dtype=torch.float32)
        got = new.decide(loss)
        want = old.decide(loss)
        assert [bool(t) for t in got] == [bool(t) for t in want]
        new.advance(loss, *got)
        old.advance(loss, *want)
        for name in STATE:
            a, b = getattr(new, name), getattr(old, name)
            assert a.dtype == b.dtype and torch.equal(a, b), (k, name)
    assert ids == [(id(getattr(new, k)), getattr(new, k).data_ptr())
                   for k in STATE]
    assert new.finished() == old.finished()


def test_early_stop_reset_in_place():
    stop = tfi.EarlyStop(LoopConfig(iters=3), torch.device("cpu"))
    ids = [id(getattr(stop, k)) for k in STATE]
    for value in (1.0, 1.0, 1.0, 1.0):
        loss = torch.tensor(value)
        stop.advance(loss, *stop.decide(loss))
    assert stop.finished()
    stop.reset()
    fresh = tfi.EarlyStop(LoopConfig(iters=3), torch.device("cpu"))
    for k in STATE:
        assert torch.equal(getattr(stop, k), getattr(fresh, k)), k
    assert ids == [id(getattr(stop, k)) for k in STATE]


def _key(**change):
    args = dict(device=torch.device("cuda", 0), n=6000, m=6000, level=3,
                pcfg=CFG, lcfg=LoopConfig(), trunc=1e9, n_ldmk=0, w_cd=1.0,
                w_eff=0.0)
    args.update(change)
    return tfi.level_graph_key(**args)


def test_policy_first_sight_eager_second_capture_then_replay():
    graphs = tfi.LevelGraphs()
    key, entry = _key(), object()
    assert graphs.plan(key) == (graphs.EAGER, None)
    assert graphs.plan(key) == (graphs.CAPTURE, None)
    graphs.store(key, entry)
    for _ in range(3):
        assert graphs.plan(key) == (graphs.REPLAY, entry)


def test_policy_failed_capture_stays_eager():
    graphs = tfi.LevelGraphs()
    key = _key()
    graphs.plan(key)
    assert graphs.plan(key)[0] == graphs.CAPTURE
    graphs.store(key, None)
    for _ in range(3):
        assert graphs.plan(key) == (graphs.EAGER, None)


@pytest.mark.parametrize("change", [
    dict(level=4), dict(n=5999), dict(m=2000),
    dict(device=torch.device("cuda", 1)),
    dict(pcfg=tpyr.NDPConfig(m=4, k0=-6, depth=3, width=64, motion="Sim3",
                             rotation_format="euler")),
    dict(lcfg=LoopConfig(iters=20)), dict(lcfg=LoopConfig(lr=0.02)),
    dict(lcfg=LoopConfig(loss_eps=1e-5)),
    dict(lcfg=LoopConfig(break_threshold_ratio=0.01)),
    dict(lcfg=LoopConfig(max_break_count=3)),
    dict(trunc=0.25), dict(n_ldmk=12), dict(w_cd=0.5), dict(w_eff=0.1),
])
def test_policy_a_changed_input_is_a_new_key(change):
    """Whatever capture bakes in is in the key: a level differing in one of
    them starts at its own first sight, eager."""
    graphs = tfi.LevelGraphs()
    base = _key()
    graphs.plan(base)
    graphs.plan(base)
    graphs.store(base, object())
    other = _key(**change)
    assert other != base and hash(other) is not None
    assert graphs.plan(other) == (graphs.EAGER, None)
    assert graphs.plan(other)[0] == graphs.CAPTURE
    assert graphs.plan(base)[0] == graphs.REPLAY


def test_policy_lru_bound():
    """At most ``size`` keys: the least recently used is dropped (its
    graph with it) and starts again at its first sight; a key used again
    is kept. ``size`` 0 keeps nothing: every level eager."""
    graphs = tfi.LevelGraphs(size=3)
    keys = [_key(level=k) for k in range(4)]
    for k in keys[:3]:
        graphs.plan(k)
        graphs.plan(k)
        graphs.store(k, object())
    graphs.plan(keys[0])                    # keys[0] the most recent now
    assert graphs.plan(keys[3])[0] == graphs.EAGER    # drops keys[1]
    assert len(graphs._keys) == 3
    assert graphs.plan(keys[0])[0] == graphs.REPLAY
    assert graphs.plan(keys[2])[0] == graphs.REPLAY
    assert graphs.plan(keys[1])[0] == graphs.EAGER
    none = tfi.LevelGraphs(size=0)
    for _ in range(3):
        assert none.plan(keys[0]) == (none.EAGER, None)
    assert not none._keys


# --- the graph path's plumbing on the CPU, with a fake graph ---------------

class _FakeGraph:
    """Stands in for a captured block: a replay calls the step that was to
    be captured ``SYNC_EVERY`` times, on the same tensors."""

    def __init__(self, step, pool):
        self.step = step

    def replay(self):
        for _ in range(tfi.SYNC_EVERY):
            self.step()


def _level(seed=3, n=150, m=170, n_ldmk=0):
    gen = torch.Generator().manual_seed(seed)
    params = tpyr.level_params(tpyr.init_pyramid_params(gen, CFG), LEVEL)
    pts = torch.randn(n, 3, generator=gen) * 0.4
    tgt = torch.randn(m, 3, generator=gen) * 0.4
    pv = torch.rand(n, generator=gen) > 0.1
    tv = torch.rand(m, generator=gen) > 0.1
    ldmk = {}
    if n_ldmk:
        ldmk = dict(n_ldmk=n_ldmk,
                    tgt_ldmk=pts[:n_ldmk]
                    + torch.randn(n_ldmk, 3, generator=gen) * 0.05,
                    ldmk_valid=torch.rand(n_ldmk, generator=gen) > 0.2)
    return params, pts, pv, tgt, tv, ldmk


def _graph_run(inputs, lcfg, trunc=1e9, w_cd=1.0):
    params, pts, pv, tgt, tv, ldmk = inputs
    n_ldmk = ldmk.get("n_ldmk", 0)
    t = tfi._level_tensors(params, pts, pv, tgt, tv, n_ldmk,
                           ldmk.get("tgt_ldmk"), ldmk.get("ldmk_valid"), CFG)
    return tfi._graph_level(t, tpyr.level_shapes(CFG),
                            (LEVEL, CFG, lcfg, trunc, n_ldmk, w_cd, 0.0))


def _eager_run(inputs, lcfg, trunc=1e9, w_cd=1.0):
    params, pts, pv, tgt, tv, ldmk = inputs
    return tfi.run_fused_level(params, pts, pv, tgt, tv, LEVEL, CFG, lcfg,
                               trunc=trunc, w_cd=w_cd, **ldmk)


def _flat(out):
    params, aux, stats = out
    return [tpyr.ravel(params), aux, stats["iters"], stats["loss"]]


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(b)))


@pytest.fixture
def fake_graphs(monkeypatch):
    """A fresh cache whose captures are fake graphs, the counters recorded
    and from zero."""
    graphs = tfi.LevelGraphs()
    monkeypatch.setattr(tfi, "_GRAPHS", graphs)
    monkeypatch.setattr(tfi, "_record", _FakeGraph)
    monkeypatch.setattr(tfi.LevelGraphs, "pool", lambda self: None)
    monkeypatch.setattr(timers, "recording", lambda: True)
    timers.reset_counters()
    yield graphs
    timers.reset_counters()


def _counts():
    got = timers.counters()
    return {k: got.get(k, 0) for k in COUNTERS}


@pytest.mark.parametrize("lcfg,kw", [
    (LoopConfig(iters=60), {}),
    # the cap at a non-multiple of SYNC_EVERY: the last block's
    # iterations past it are no-ops
    (LoopConfig(iters=20, loss_eps=0.0, max_break_count=10 ** 9), {}),
    (LoopConfig(iters=40), dict(n_ldmk=12)),
])
def test_graph_path_plumbing_matches_eager(fake_graphs, lcfg, kw):
    """First sight eager, second captured and replayed, third replayed on
    other inputs: each bit-equal to the eager loop on the same inputs; the
    tensors a level returned are unchanged after two more levels of the
    key; the counters."""
    trunc = 0.25 if kw else 1e9
    a, b = _level(seed=3, **kw), _level(seed=4, **kw)
    a_inputs = [t.clone() for t in a[1:5]]
    want_a = _eager_run(a, lcfg, trunc)
    want_b = _eager_run(b, lcfg, trunc)
    timers.reset_counters()
    assert _graph_run(a, lcfg, trunc) is None          # first sight
    got = _graph_run(a, lcfg, trunc)                   # capture, replay
    assert _equal(got, want_a)
    kept = [t.clone() for t in _flat(got)]
    for inputs, want in ((b, want_b), (a, want_a)):    # replays
        assert _equal(_graph_run(inputs, lcfg, trunc), want)
    assert all(torch.equal(x, y) for x, y in zip(_flat(got), kept))
    # the capture's inputs were not the graph's: b's did not land in them
    assert all(torch.equal(x, y) for x, y in zip(a[1:5], a_inputs))
    (entry,) = [v for v in fake_graphs._keys.values() if v is not None]
    static = {t.untyped_storage().data_ptr() for t in entry.tensors.values()}
    assert not _storages(got) & static
    c = _counts()
    assert c["fused_level.graph_captures"] == 1
    assert c["fused_level.graph_failures"] == 0
    replays = c["fused_level.graph_replays"]
    assert replays >= 3
    assert c["fused_level.blocks"] == replays


def _storages(out):
    params, aux, stats = out
    leaves = [t for d in params.values() for t in
              (d.values() if isinstance(d, dict) else [d])]
    return {t.untyped_storage().data_ptr()
            for t in [*leaves, aux, *stats.values()]}


def test_graph_path_counts_blocks_and_noops(fake_graphs):
    """A capped level of 20 iterations: the eager loop issues 20 calls in 3
    blocks; the graph path replays 3 blocks of 8, whose last 4 calls are
    no-ops, and counts them."""
    lcfg = LoopConfig(iters=20, loss_eps=0.0, max_break_count=10 ** 9)
    a = _level()
    _eager_run(a, lcfg)
    c = _counts()
    assert c["fused_level.blocks"] == 3 and c["early_stop.noops"] == 0
    assert _graph_run(a, lcfg) is None          # first sight: no graph
    assert _counts() == c
    _graph_run(a, lcfg)
    c = _counts()
    assert c["fused_level.blocks"] == 6
    assert c["fused_level.graph_replays"] == 3
    assert c["early_stop.noops"] == 4


def test_graph_counts_launches_at_each_replay(monkeypatch, fake_graphs):
    """A capture records launches and runs none: a kernel's ``launches``
    takes them back out and adds a block's at each replay; a capture that
    fails leaves the count as it was."""
    kernel = types.SimpleNamespace(launches=5)
    monkeypatch.setattr(cuda_lib, "KERNELS", [kernel])

    class Capturing(_FakeGraph):
        def __init__(self, step, pool):
            super().__init__(step, pool)
            kernel.launches += 2 * tfi.SYNC_EVERY    # as a capture counts

    def broken(step, pool):
        kernel.launches += 3
        raise RuntimeError("capture failed")

    monkeypatch.setattr(tfi, "_record", Capturing)
    lcfg = LoopConfig(iters=20, loss_eps=0.0, max_break_count=10 ** 9)
    a = _level()
    assert _graph_run(a, lcfg) is None           # first sight: no graph
    assert kernel.launches == 5
    block = 2 * tfi.SYNC_EVERY
    _graph_run(a, lcfg)                          # capture, 3 replays
    assert kernel.launches == 5 + 3 * block
    _graph_run(a, lcfg)                          # 3 replays
    assert kernel.launches == 5 + 6 * block
    monkeypatch.setattr(tfi, "_record", broken)
    other = LoopConfig(iters=30)
    assert _graph_run(a, other) is None
    with pytest.warns(UserWarning, match="capture"):
        assert _graph_run(a, other) is None
    assert kernel.launches == 5 + 6 * block


def test_failed_capture_runs_eagerly(monkeypatch, fake_graphs):
    """A capture that raises leaves the level to the eager loop (None from
    the graph path, the inputs untouched), counted, and the key eager."""
    def broken(step, pool):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(tfi, "_record", broken)
    lcfg = LoopConfig(iters=30)
    a = _level()
    params = tpyr.ravel(a[0]).clone()
    assert _graph_run(a, lcfg) is None
    with pytest.warns(UserWarning, match="capture"):
        assert _graph_run(a, lcfg) is None
    assert torch.equal(tpyr.ravel(a[0]), params)
    assert _counts()["fused_level.graph_failures"] == 1
    assert _graph_run(a, lcfg) is None
    assert _counts()["fused_level.graph_failures"] == 1


def test_busy_cache_runs_eagerly(fake_graphs):
    """While another thread holds the graphs' buffers, a level runs the
    eager loop and the cache is not consulted."""
    a = _level()
    with fake_graphs.lock:
        assert _graph_run(a, LoopConfig(iters=30)) is None
    assert not fake_graphs._keys


# --- run_fused_level on CPU tensors: the loop as it was before the graph ---

def _frozen_level(lvl_params, pts, pts_valid, t_sample, t_valid, level, pcfg,
                  lcfg, trunc=1e9, n_ldmk=0, tgt_ldmk=None, ldmk_valid=None,
                  w_cd=1.0, w_reg=0.0):
    """``run_fused_level`` as it stood before the level graph: every state
    a new tensor each iteration."""
    from deformationpyramid_tpu_torch.losses import bce_with_zeros_target

    shapes = tpyr.level_shapes(pcfg)
    p = tpyr.ravel(lvl_params).to(torch.float32).contiguous().clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    x = pts.to(torch.float32).contiguous()
    y = t_sample.to(torch.float32).contiguous()
    n = x.shape[0]
    rows = torch.arange(n, device=x.device)
    row_valid = pts_valid.to(torch.bool)
    xv = (row_valid & (rows >= n_ldmk)).contiguous()
    yv = t_valid.to(torch.bool).contiguous()
    x_len = torch.clamp_min(xv.sum(), 1).to(torch.float32)
    y_len = torch.clamp_min(yv.sum(), 1).to(torch.float32)
    if n_ldmk > 0:
        lmask = torch.zeros(n, dtype=torch.float32, device=x.device)
        lmask[:n_ldmk] = ldmk_valid.to(torch.float32)
        lcount = torch.clamp_min(lmask.sum(), 1.0)
        ltgt = torch.zeros_like(x)
        ltgt[:n_ldmk] = tgt_ldmk.to(torch.float32)
    nonrigid = bool(pcfg.nonrigidity_est)
    w_eff = float(w_reg) if nonrigid and level > 0 else 0.0
    zeros_nr = torch.zeros(n, dtype=torch.float32, device=x.device) \
        if nonrigid else None
    stop = _Rebinding(lcfg, x.device)
    aux = x.clone()

    def exact():
        nonlocal aux
        if nonrigid:
            warped, nr = tfi.level_warp_fwd_nr(p, x, level, pcfg)
        else:
            warped, nr = tfi.level_warp_fwd(p, x, level, pcfg), None
        _, cidx, _, rarg = tfi.nn_argmin_dual(warped, y, xv, yv)
        loss, g = tfi._chamfer_glue(warped, cidx, rarg, y, xv, yv, x_len,
                                    y_len, trunc)
        if n_ldmk > 0:
            diff = (warped - ltgt) * lmask[:, None]
            loss = torch.sum(diff * diff) / lcount + w_cd * loss
            g = (2.0 / lcount) * diff + w_cd * g
        g_nr = zeros_nr
        if w_eff > 0:
            reg, vjp = torch.func.vjp(
                lambda q: bce_with_zeros_target(q, row_valid), nr)
            loss = loss + w_eff * reg
            (g_nr,) = vjp(torch.tensor(w_eff, device=nr.device))
        halt, hold = stop.decide(loss)
        partials = tfi.level_warp_bwd(p, x, g, level, pcfg, g_nr)
        tfi.adam_step(p, m, v, partials, stop.applied,
                      hold.to(torch.float32), lcfg.lr)
        stop.advance(loss, halt, hold)
        aux = torch.where(halt, aux, warped)

    tfi.EarlyStop.run(stop, exact)
    return tpyr.unravel(p, shapes), aux, stop.stats()


NR_CFG = tpyr.NDPConfig(m=4, k0=-6, depth=3, width=64, nonrigidity_est=True)


@pytest.mark.parametrize("mode", ["chamfer", "landmark", "nonrigid",
                                  "capped"])
def test_run_fused_level_on_cpu_unchanged(monkeypatch, mode):
    """On CPU tensors the level loop is the eager one, bit-equal to the
    loop as it was before the graph, and the cache is never consulted."""
    graphs = tfi.LevelGraphs()
    monkeypatch.setattr(tfi, "_GRAPHS", graphs)
    params, pts, pv, tgt, tv, ldmk = _level(
        n_ldmk=12 if mode == "landmark" else 0)
    cfg, kw = CFG, dict(ldmk)
    lcfg = LoopConfig(iters=40)
    if mode == "landmark":
        kw["trunc"] = 0.25
    if mode == "nonrigid":
        cfg, kw["w_reg"] = NR_CFG, 0.2
        params = tpyr.level_params(tpyr.init_pyramid_params(
            torch.Generator().manual_seed(5), NR_CFG), LEVEL)
    if mode == "capped":
        lcfg = LoopConfig(iters=20, loss_eps=0.0, max_break_count=10 ** 9)
    got = tfi.run_fused_level(params, pts, pv, tgt, tv, LEVEL, cfg, lcfg,
                              **kw)
    want = _frozen_level(params, pts, pv, tgt, tv, LEVEL, cfg, lcfg, **kw)
    assert _equal(got, want)
    assert not graphs._keys
    if mode == "capped":
        assert int(got[2]["iters"]) == 20


@pytest.mark.parametrize("k", [1, 8, 13])
def test_level_step_matches_the_loop(k):
    """``_level_step``'s one function, called k times by hand on a level's
    tensors, gives the params, aux, iterations and loss of
    ``run_fused_level`` capped at k iterations, bit for bit: the one
    iteration that the eager loop calls and a captured block records."""
    params, pts, pv, tgt, tv, _ = _level()
    lcfg = LoopConfig(iters=k)
    want = tfi.run_fused_level(params, pts, pv, tgt, tv, LEVEL, CFG, lcfg)
    t = tfi._level_tensors(params, pts, pv, tgt, tv, 0, None, None, CFG)
    stop = tfi.EarlyStop(lcfg, torch.device("cpu"))
    step = tfi._level_step(t, stop, LEVEL, CFG, lcfg, 1e9, 0, 1.0, 0.0)
    for _ in range(k):
        step()
    got = (tpyr.unravel(t["p"], tpyr.level_shapes(CFG)), t["aux"],
           stop.stats())
    assert _equal(got, want)
    assert int(stop.it) == k


def test_run_fused_level_reads_no_environment(monkeypatch):
    """The level loop takes no route from the environment: the module
    holds no handle on it, and with every read of ``os.environ`` raising,
    a level's outputs and counters are bit-equal to a run beside it."""
    assert not {"os", "environ", "getenv"} & set(vars(tfi))
    monkeypatch.setattr(timers, "recording", lambda: True)
    inputs, lcfg = _level(), LoopConfig(iters=30)
    timers.reset_counters()
    plain, plain_counts = _eager_run(inputs, lcfg), _counts()

    class _NoEnviron(dict):
        def _read(self, *a, **k):
            raise AssertionError("the level loop read the environment")
        __getitem__ = get = __contains__ = __iter__ = keys = items = _read

    timers.reset_counters()
    with monkeypatch.context() as m:
        m.setattr(os, "environ", _NoEnviron())
        sealed = _eager_run(inputs, lcfg)
    sealed_counts = _counts()
    timers.reset_counters()
    assert _equal(sealed, plain)
    assert sealed_counts == plain_counts
    assert plain_counts["fused_level.blocks"] > 0


# --- on the card -------------------------------------------------------------

@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(timers, "recording", lambda: True)
    timers.reset_counters()
    yield torch.device("cuda")
    timers.reset_counters()


SIM3 = tpyr.NDPConfig(m=9, k0=-8, depth=3, width=128, motion="Sim3",
                      rotation_format="euler")
SE3 = tpyr.NDPConfig(m=9, k0=-8, depth=3, width=128)
NR9 = tpyr.NDPConfig(m=9, k0=-8, depth=3, width=128, nonrigidity_est=True)
CASES = {
    # the shape transfer's level: 6000 samples a side
    "sim3-6000": dict(pcfg=SIM3, n=6000, m=6000, level=2, pad=False),
    # NDP's main path at 2000 points, padded rows in both clouds
    "se3-2000-padded": dict(pcfg=SE3, n=2000, m=2000, level=4, pad=True),
    # a level that hits its cap at a non-multiple of SYNC_EVERY
    "capped-20": dict(pcfg=SE3, n=2000, m=1800, level=1, pad=True,
                      lcfg=LoopConfig(iters=20, loss_eps=0.0,
                                      max_break_count=10 ** 9)),
    # landmark + chamfer mode (LNDP with w_cd > 0)
    "landmark": dict(pcfg=SE3, n=2000, m=2000, level=3, pad=True,
                     n_ldmk=100),
    # the nonrigidity head at level 0, where its BCE term is gated off
    "nonrigid-level0": dict(pcfg=NR9, n=2000, m=2000, level=0, pad=True,
                            w_reg=0.2),
}


def _card_inputs(case, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    pcfg, n, m = case["pcfg"], case["n"], case["m"]
    n_ldmk = case.get("n_ldmk", 0)
    params = tpyr.level_params(tpyr.init_pyramid_params(gen, pcfg),
                               case["level"])
    pts = torch.randn(n + n_ldmk, 3, generator=gen) * 0.4
    tgt = pts[:m] * 1.05 + torch.randn(m, 3, generator=gen) * 0.02 + 0.03
    pv = torch.ones(n + n_ldmk, dtype=torch.bool)
    tv = torch.ones(m, dtype=torch.bool)
    if case["pad"]:
        pv[-37:] = False
        tv[-53:] = False
    kw = dict(trunc=0.25 if n_ldmk else 1e9, w_reg=case.get("w_reg", 0.0))
    if n_ldmk:
        kw.update(n_ldmk=n_ldmk,
                  tgt_ldmk=(pts[:n_ldmk] * 1.1).to(dev),
                  ldmk_valid=(torch.rand(n_ldmk, generator=gen)
                              > 0.2).to(dev))
    return (tpyr.tree_map(lambda t: t.to(dev), params), pts.to(dev),
            pv.to(dev), tgt.to(dev), tv.to(dev), kw)


def _card_run(case, inputs, monkeypatch=None, graphs=None):
    params, pts, pv, tgt, tv, kw = inputs
    if monkeypatch is not None:
        monkeypatch.setattr(tfi, "_GRAPHS", graphs)
    out = tfi.run_fused_level(params, pts, pv, tgt, tv, case["level"],
                              case["pcfg"], case.get("lcfg", LoopConfig()),
                              **kw)
    return [t.clone() for t in _flat(out)], out


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_replay_bit_equal_to_eager_on_card(dev, monkeypatch, name):
    """Eager (a cache that keeps nothing) against the graph path's first
    sight (eager), second (capture and replay) and third and fourth
    (replays on other inputs, then the first again): params, aux,
    iterations and loss bit-equal; what the second sight returned is
    unchanged after the two later levels of its key; one capture, and
    replays by the third sight."""
    case = CASES[name]
    a, b = _card_inputs(case, dev, 11), _card_inputs(case, dev, 12)
    eager = tfi.LevelGraphs(size=0)
    want_a, _ = _card_run(case, a, monkeypatch, eager)
    want_b, _ = _card_run(case, b, monkeypatch, eager)
    graphs = tfi.LevelGraphs()
    runs = [_card_run(case, x, monkeypatch, graphs) for x in (a, a, b, a)]
    torch.cuda.synchronize()
    for (got, _), want in zip(runs, (want_a, want_a, want_b, want_a)):
        assert all(torch.equal(x, y) for x, y in zip(got, want)), name
    kept, live = runs[1]
    assert all(torch.equal(x, y) for x, y in zip(_flat(live), kept))
    c = _counts()
    assert c["fused_level.graph_captures"] == 1, c
    assert c["fused_level.graph_failures"] == 0, c
    assert c["fused_level.graph_replays"] >= 3, c
    if name == "capped-20":
        assert all(int(r[0][2]) == 20 for r in runs)


@pytest.mark.cuda
def test_nonrigid_bce_levels_stay_eager_on_card(dev, monkeypatch):
    """A level with the BCE term (the head at level > 0, ``w_reg > 0``)
    never reaches the cache."""
    case = dict(CASES["nonrigid-level0"], level=2)
    graphs = tfi.LevelGraphs()
    inputs = _card_inputs(case, dev, 13)
    for _ in range(3):
        _card_run(case, inputs, monkeypatch, graphs)
    assert not graphs._keys
    assert _counts()["fused_level.graph_captures"] == 0


@pytest.mark.cuda
def test_launches_count_the_calls_issued_on_card(dev, monkeypatch):
    """Over three sights of one key (eager; capture and replay; replay),
    every kernel's ``launches`` grows by its launches a call times the
    calls the level issued (its iterations and its no-ops), as in the
    eager loop: a capture counts nothing, a replay its block."""
    case = CASES["se3-2000-padded"]
    graphs = tfi.LevelGraphs()
    per_call = None
    for seed in (11, 12, 11):
        inputs = _card_inputs(case, dev, seed)
        torch.cuda.synchronize()
        before = {k.name: k.launches for k in cuda_lib.KERNELS}
        noops = timers.counters().get("early_stop.noops", 0)
        got, _ = _card_run(case, inputs, monkeypatch, graphs)
        issued = (int(got[2]) - noops
                  + timers.counters().get("early_stop.noops", 0))
        grew = {k.name: k.launches - before[k.name] for k in cuda_lib.KERNELS
                if k.launches != before[k.name]}
        if per_call is None:
            per_call = {name: n // issued for name, n in grew.items()}
        assert grew == {name: r * issued for name, r in per_call.items()}, \
            (seed, issued, grew)
    for name in ("nn_dual", "level_warp_fwd", "level_warp_bwd", "adam_step"):
        assert per_call[name] == 1, per_call
    c = _counts()
    assert c["fused_level.graph_captures"] == 1, c
    assert c["fused_level.graph_replays"] > 0, c
