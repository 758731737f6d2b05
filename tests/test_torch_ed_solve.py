"""Parity of the port's embedded-deformation solver with the JAX package
on the CPU: ``LoopConfig.lr_decay`` (optax's ``exponential_decay``) and
``solve/baselines.register_ed`` on the same numpy inputs.

With ``samples`` at least both cloud sizes every resample is a permutation,
so the loss does not depend on the two packages' different random streams.

Tolerances: the decayed Adam trajectory 1e-6 of optax's over 50 steps; one
ED iteration's loss and gradient 1e-6 relative (sums in other orders); a
toy solve (``tests/test_baselines.py``'s graph) over 40 iterations with
iteration counts within 2 and warps within 1e-3; the whole 150-iteration
toy solve with iteration counts within 2 and warps no farther from JAX's
than twice JAX's own spread between two keys (float32 rounding parts the
trajectories past ~45 iterations, the reference's as much as the port's);
a repeated solve on one seed bit-equal.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from deformationpyramid_tpu.data.synthetic import make_pair
from deformationpyramid_tpu.solve import baselines as jsolve
from deformationpyramid_tpu_torch.ops import fused_iteration as tfi
from deformationpyramid_tpu_torch.solve import baselines as tsolve
from deformationpyramid_tpu_torch.solve import loop as tloop


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_graph(src, n_nodes=16, k_edges=4, k_anchor=4, coverage=0.5):
    """``tests/test_baselines.py``'s numpy deformation graph."""
    rng = np.random.default_rng(0)
    nodes = src[rng.permutation(len(src))[:n_nodes]]
    d_nn = ((nodes[:, None] - nodes[None]) ** 2).sum(-1)
    np.fill_diagonal(d_nn, np.inf)
    edges = np.argsort(d_nn, axis=1)[:, :k_edges].astype(np.int32)
    ew = np.ones((n_nodes, k_edges), np.float32) / k_edges
    d_pa = ((src[:, None] - nodes[None]) ** 2).sum(-1)
    anchors = np.argsort(d_pa, axis=1)[:, :k_anchor].astype(np.int32)
    ad = np.take_along_axis(d_pa, anchors, axis=1)
    aw = np.exp(-ad / (2 * coverage ** 2))
    aw = (aw / aw.sum(1, keepdims=True)).astype(np.float32)
    return nodes, edges, ew, anchors, aw


def _problem(n=200, seed=3):
    src, tgt, flow_gt = make_pair(n=n, seed=seed, deform=0.1, rigid=True)
    return (src, tgt, flow_gt) + _toy_graph(src)


def _jax_args(src, tgt, nodes, edges, ew, anchors, aw):
    return [jnp.asarray(a) for a in (src, tgt, nodes, edges, ew, anchors, aw)]


def _torch_args(src, tgt, nodes, edges, ew, anchors, aw):
    out = [torch.from_numpy(np.ascontiguousarray(a))
           for a in (src, tgt, nodes, edges, ew, anchors, aw)]
    out[3] = out[3].long()
    out[5] = out[5].long()
    return out


def _ldmk(n_src, n_tgt, n=12, seed=5):
    rng = np.random.default_rng(seed)
    s_idx = rng.permutation(n_src)[:n].astype(np.int64)
    t_idx = rng.permutation(n_tgt)[:n].astype(np.int64)
    valid = rng.random(n) > 0.2
    return s_idx, t_idx, valid


def test_lr_decay_matches_optax_exponential_decay():
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(40).astype(np.float32)
    target = rng.standard_normal(40).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 40).astype(np.float32)
    lr, gamma, steps = 0.05, 0.9, 50

    opt = optax.adam(optax.exponential_decay(lr, transition_steps=1,
                                             decay_rate=gamma))
    jp = jnp.asarray(p0)
    state = opt.init(jp)
    grad = jax.grad(lambda p: jnp.sum(jnp.asarray(scale)
                                      * (p - jnp.asarray(target)) ** 2))
    for _ in range(steps):
        upd, state = opt.update(grad(jp), state, jp)
        jp = optax.apply_updates(jp, upd)

    cfg = tloop.LoopConfig(iters=steps, lr=lr, lr_decay=gamma,
                           max_break_count=10 ** 6,
                           break_threshold_ratio=0.0, loss_eps=-1.0)
    tt, ts = torch.from_numpy(target), torch.from_numpy(scale)
    out, _, stats = tloop.run_adam_loop(
        lambda p, it: (torch.sum(ts * (p["p"] - tt) ** 2), None),
        {"p": torch.from_numpy(p0)}, cfg)
    assert int(stats["iters"]) == steps
    assert float(np.abs(out["p"].numpy() - np.asarray(jp)).max()) < 1e-6


def test_adam_rate_reaching_c4(monkeypatch):
    """Without a decay every step hands C4 ``lr`` itself, as before the
    decay existed; with one, the k-th step hands it lr * g^k, and the
    steps after the stop are held."""
    seen = []

    def spy(p, m, v, partials, applied, hold, lr):
        seen.append((lr, float(applied), float(hold)))
        tfi.adam_step_plain(p, m, v, partials, applied, hold, lr)

    monkeypatch.setattr(tloop, "adam_step", spy)
    loss = lambda p, it: (torch.sum(p["p"] ** 2), None)   # noqa: E731
    p = {"p": torch.ones(5)}
    tloop.run_adam_loop(loss, p, tloop.LoopConfig(iters=12, lr=0.2))
    assert [s[0] for s in seen] == [0.2] * 12
    seen.clear()
    tloop.run_adam_loop(loss, p, tloop.LoopConfig(
        iters=12, lr=0.2, lr_decay=0.9, loss_eps=0.5))
    applied = [s for s in seen if s[2] < 0.5]
    assert 0 < len(applied) < len(seen)
    for k, (lr, done, _) in enumerate(applied):
        assert done == k and lr == 0.2 * 0.9 ** k


def _capture(monkeypatch, module):
    """Replace ``module.run_adam_loop`` by one that records the loss
    function and returns the initial parameters."""
    box = {}

    def fake(loss_fn, params, cfg, **kw):
        box.update(loss_fn=loss_fn, params=params, cfg=cfg, kw=kw)
        stats = {"iters": 0, "loss": 0.0}
        return params, None, stats

    monkeypatch.setattr(module, "run_adam_loop", fake)
    return box


@pytest.mark.parametrize("landmarks", [False, True])
def test_one_ed_iteration_matches_jax(monkeypatch, landmarks):
    src, tgt, _, nodes, edges, ew, anchors, aw = _problem()
    ev = np.random.default_rng(1).random(edges.shape) > 0.2
    jkw, tkw = {}, {}
    if landmarks:
        s_idx, t_idx, lv = _ldmk(len(src), len(tgt))
        jkw = dict(src_ldmk_idx=jnp.asarray(s_idx),
                   tgt_ldmk_idx=jnp.asarray(t_idx), ldmk_valid=jnp.asarray(lv))
        tkw = dict(src_ldmk_idx=torch.from_numpy(s_idx),
                   tgt_ldmk_idx=torch.from_numpy(t_idx),
                   ldmk_valid=torch.from_numpy(lv))
    jcfg = jsolve.EDSolverConfig(samples=256, use_pallas=False)
    tcfg = tsolve.EDSolverConfig(samples=256)
    jbox = _capture(monkeypatch, jsolve)
    tbox = _capture(monkeypatch, tsolve)
    jsolve.register_ed(jax.random.key(0), *_jax_args(src, tgt, nodes, edges,
                                                     ew, anchors, aw),
                       jcfg, edges_valid=jnp.asarray(ev), **jkw)
    tsolve.register_ed(0, *_torch_args(src, tgt, nodes, edges, ew, anchors,
                                       aw),
                       tcfg, edges_valid=torch.from_numpy(ev), **tkw)
    assert tbox["cfg"].lr_decay == jbox["cfg"].lr_decay == 0.999
    assert isinstance(tbox["kw"]["gen"], torch.Generator)

    rng = np.random.default_rng(2)
    p = {"phi": (rng.standard_normal(nodes.shape) * 0.1).astype(np.float32),
         "t": (rng.standard_normal(nodes.shape) * 0.05).astype(np.float32)}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda q: jbox["loss_fn"](q, jnp.int32(0), jax.random.key(1))[0]))(
        {k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tl = tbox["loss_fn"](tp, torch.zeros((), dtype=torch.int32),
                         torch.Generator().manual_seed(1))[0]
    tg = torch.autograd.grad(tl, [tp["phi"], tp["t"]])
    tl = tl.detach()
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    for got, ref in zip(tg, (jg["phi"], jg["t"])):
        ref = np.asarray(ref)
        err = float(np.abs(got.numpy() - ref).max())
        assert err <= 1e-6 * float(np.abs(ref).max()), err


def _solve_both(iters, key, landmarks=False):
    src, tgt, flow_gt, nodes, edges, ew, anchors, aw = _problem()
    jkw, tkw = {}, {}
    if landmarks:
        s_idx = np.arange(0, len(src), 10)
        t_idx = s_idx.copy()        # make_pair's target is the moved source
        lv = np.ones(len(s_idx), bool)
        jkw = dict(src_ldmk_idx=jnp.asarray(s_idx),
                   tgt_ldmk_idx=jnp.asarray(t_idx), ldmk_valid=jnp.asarray(lv))
        tkw = dict(src_ldmk_idx=torch.from_numpy(s_idx),
                   tgt_ldmk_idx=torch.from_numpy(t_idx),
                   ldmk_valid=torch.from_numpy(lv))
    jcfg = jsolve.EDSolverConfig(iters=iters, samples=256, use_pallas=False)
    tcfg = tsolve.EDSolverConfig(iters=iters, samples=256)
    jw, js = jax.jit(lambda k, *a: jsolve.register_ed(k, *a, jcfg, **jkw))(
        jax.random.key(key), *_jax_args(src, tgt, nodes, edges, ew, anchors,
                                        aw))
    tw, ts = tsolve.register_ed(key, *_torch_args(src, tgt, nodes, edges, ew,
                                                  anchors, aw), tcfg, **tkw)
    assert abs(int(ts["iters"]) - int(js["iters"])) <= 2, \
        (int(ts["iters"]), int(js["iters"]))
    before = np.linalg.norm(flow_gt, axis=-1).mean()
    for w in (tw.numpy(), np.asarray(jw)):
        assert np.linalg.norm(w - src - flow_gt, axis=-1).mean() < 0.5 * before
    return tw.numpy(), np.asarray(jw)


@pytest.mark.parametrize("landmarks", [False, True])
def test_ed_solve_matches_jax(landmarks):
    """40 iterations, where the toy solve has come 0.5x below its initial
    flow and float32 has not yet parted the two trajectories."""
    tw, jw = _solve_both(40, 3, landmarks)
    assert float(np.abs(tw - jw).max()) < 1e-3


def test_ed_whole_toy_solve_within_the_references_own_spread():
    """The JAX test's whole toy solve (150 iterations). Past ~45 iterations
    float32 rounding parts any two runs: the JAX package's own solve on two
    keys, which differ only in the order the permuted samples are summed,
    ends 3.1e-3 apart. The port must end no farther from JAX than that
    (2x its measured spread), with iteration counts within 2."""
    tw, jw = _solve_both(150, 3)
    src, tgt, _, nodes, edges, ew, anchors, aw = _problem()
    jcfg = jsolve.EDSolverConfig(iters=150, samples=256, use_pallas=False)
    jw4, _ = jax.jit(lambda k, *a: jsolve.register_ed(k, *a, jcfg))(
        jax.random.key(4), *_jax_args(src, tgt, nodes, edges, ew, anchors,
                                      aw))
    spread = float(np.abs(np.asarray(jw4) - jw).max())
    assert float(np.abs(tw - jw).max()) <= 2.0 * spread


def test_ed_solve_repeats_on_one_seed():
    """Resampling draws from the seed's stream: one seed, one result; the
    samples here are fewer than the points, so the stream matters."""
    src, tgt, _, nodes, edges, ew, anchors, aw = _problem()
    cfg = tsolve.EDSolverConfig(iters=40, samples=64)
    args = _torch_args(src, tgt, nodes, edges, ew, anchors, aw)
    a, sa = tsolve.register_ed(11, *args, cfg)
    b, sb = tsolve.register_ed(11, *args, cfg)
    c, _ = tsolve.register_ed(12, *args, cfg)
    assert int(sa["iters"]) == int(sb["iters"])
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
