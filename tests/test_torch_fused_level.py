"""Parity of the port's standalone level warp (``ops/fused_level.py``: C2
forward, C3 + C13 backward, here their plain versions) with the JAX
package's ``fused_level_warp`` / ``fused_level_warp_t`` (Pallas interpret
mode, exact wide matmuls), on the CPU.

Tolerances: the forward 1e-6 max abs; the gradients 1e-5 of the level's
largest |g|, on points and a target where float32 is that accurate (on
random clouds with a target unrelated to them, both packages' float32
gradients sit up to 2e-4 of a tensor's max from the float64 one, the
rotation head's bias worst: 1 / theta amplifies the rounding); the solver
routes (``use_fused``, ``use_fused`` +
``transposed``, ``transposed`` alone) against the JAX package's same route
from the same weights and points: equal per-level iteration counts and the
warp within 1e-3 (the bound of tests/test_fused_level.py:142-180).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deformationpyramid_tpu.models import pyramid as jpyr
from deformationpyramid_tpu.ops import fused_level as jfl
from deformationpyramid_tpu.solve import registration as jreg
from deformationpyramid_tpu_torch.models import pyramid as tpyr
from deformationpyramid_tpu_torch.ops import fused_level as tfl
from deformationpyramid_tpu_torch.solve import registration as treg

KW = dict(m=4, k0=-4, depth=3, width=64, rotation_format="axis_angle",
          motion="SE3")
JCFG = jpyr.NDPConfig(**KW)
TCFG = tpyr.NDPConfig(**KW)
LEVEL = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread a worker, not a pool that
    contends with the other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _exact_jax_kernels():
    """The [3, N] kernels' wide matmuls in full float32, as the JAX tests
    pin them."""
    prev = jfl._WIDE_MODE
    jfl._WIDE_MODE = "highest"
    try:
        yield
    finally:
        jfl._WIDE_MODE = prev


def _setup(n=256, seed=0):
    """One level's weights from the JAX init (numpy), points, a target."""
    lvl = jax.tree.map(np.asarray, jpyr.level_params(
        jpyr.init_pyramid_params(jax.random.key(seed), JCFG), LEVEL))
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 3)) * 0.4).astype(np.float32)
    y = (rng.normal(size=(n, 3)) * 0.4).astype(np.float32)
    return lvl, x, y


def _grads_close(tree, ref, tol=1e-5):
    scale = max(np.abs(np.asarray(ref[k][kk])).max()
                for k in ref for kk in ref[k])
    for key in ref:
        for leaf in ref[key]:
            a = np.asarray(ref[key][leaf])
            b = tree[key][leaf].detach().numpy()
            assert np.abs(a - b).max() <= tol * scale, (key, leaf)


def test_supports_fused_gate():
    assert tfl.supports_fused(TCFG)
    assert jfl.supports_fused(JCFG)
    for kw in (dict(motion="Sim3"), dict(rotation_format="quaternion"),
               dict(nonrigidity_est=True), dict(motion="sflow")):
        assert not tfl.supports_fused(tpyr.NDPConfig(**kw))
        assert not jfl.supports_fused(jpyr.NDPConfig(**kw))
    # C2 / C3 need a hidden layer, where the JAX kernels take depth 1; and
    # C3 keeps every layer's activations in one block's shared memory
    assert jfl.supports_fused(jpyr.NDPConfig(depth=1))
    assert not tfl.supports_fused(tpyr.NDPConfig(depth=1))
    assert not tfl.supports_fused(tpyr.NDPConfig(width=512))


@pytest.mark.parametrize("transposed", [False, True])
def test_fused_level_warp_matches_jax(transposed):
    """Forward within 1e-6; gradients of sum((w - y)^2) within 1e-5 of each
    tensor's max |g|; the points get a zero gradient."""
    lvl, x, y = _setup(n=256, seed=1)
    jp = jax.tree.map(jnp.asarray, lvl)
    fn = jfl.fused_level_warp_t if transposed else jfl.fused_level_warp

    def jloss(p):
        if transposed:
            w = fn(p, jnp.asarray(x).T, jnp.int32(LEVEL), JCFG,
                   interpret=True).T
        else:
            w = fn(p, jnp.asarray(x), jnp.int32(LEVEL), JCFG, interpret=True)
        return jnp.sum((w - y) ** 2), w

    (_, jw), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = tpyr.tree_map(lambda t: t.requires_grad_(True),
                       tpyr.params_from_numpy(lvl))
    tx = torch.from_numpy(x).requires_grad_(True)
    if transposed:
        tw = tfl.fused_level_warp_t(tp, tx.T, LEVEL, TCFG).T
    else:
        tw = tfl.fused_level_warp(tp, tx, LEVEL, TCFG)
    assert np.abs(tw.detach().numpy() - np.asarray(jw)).max() < 1e-6
    torch.sum((tw - torch.from_numpy(y)) ** 2).backward()
    _grads_close({k: {kk: v.grad for kk, v in d.items()}
                  for k, d in tp.items()}, jg)
    assert tx.grad is not None and not tx.grad.any()


ROUTES = {"use_fused": dict(use_fused=True),
          "use_fused+transposed": dict(use_fused=True, transposed=True),
          "transposed": dict(transposed=True)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_solver_route_matches_jax(route):
    """A 2-level solve through the route against the JAX package's same
    route from the same weights and points: equal iteration counts, the
    warp within 1e-3."""
    from deformationpyramid_tpu.data import synthetic as jsyn

    pyr = dict(m=2, k0=-6, depth=3, width=32, rotation_format="axis_angle",
               motion="SE3")
    solve = dict(iters=30, lr=0.01, max_break_count=15,
                 break_threshold_ratio=0.001, samples=128)
    src, tgt, _ = jsyn.make_pair(n=200, seed=1, deform=0.1)
    rng = np.random.default_rng(1)
    s = (src - src.mean(0))[rng.permutation(200)[:128]]
    t = (tgt - tgt.mean(0))[rng.permutation(200)[:128]]
    v = np.ones(128, bool)
    jcfg = jreg.SolverConfig(pyramid=jpyr.NDPConfig(**pyr), **solve,
                             use_pallas=False, **ROUTES[route])
    tcfg = treg.SolverConfig(pyramid=tpyr.NDPConfig(**pyr), **solve,
                             **ROUTES[route])
    key = jax.random.key(3)
    jparams, jstats = jax.jit(lambda a, b, c: jreg.optimize_pyramid(
        key, a, c, b, c, jcfg))(jnp.asarray(s), jnp.asarray(t),
                                jnp.asarray(v))
    init = tpyr.params_from_numpy(jax.tree.map(
        np.asarray, jpyr.init_pyramid_params(key, jcfg.pyramid)))
    tv = torch.from_numpy(v)
    tparams, tstats = treg.optimize_pyramid(init, torch.from_numpy(s), tv,
                                            torch.from_numpy(t), tv, tcfg)
    assert tstats["iters"].tolist() == np.asarray(jstats["iters"]).tolist()
    jw = jpyr.warp(jparams, jnp.asarray(s), jcfg.pyramid)[0]
    tw = tpyr.warp(tparams, torch.from_numpy(s), tcfg.pyramid)[0]
    assert np.abs(tw.numpy() - np.asarray(jw)).max() < 1e-3
