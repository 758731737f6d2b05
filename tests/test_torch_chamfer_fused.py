"""Parity of the port's fused chamfer (``ops/chamfer_fused.py``, the plain
version of kernel C12 here) with the JAX package's ``chamfer_l1_fused``
(its Pallas kernel in interpret mode), on the CPU.

Tolerances: the loss 1e-6, the gradient with respect to the query cloud
1e-5 (float32 on both sides, sums in another order); the row minima 1e-6
on valid rows and their arguments equal (both select on the exact squared
difference with the first index on ties; a constructed tie checks that).
The solve with ``use_fused_chamfer`` against the JAX package's same route
from the same weights: equal per-level iteration counts, the loss within
5e-3 and the warp within 2e-2 (the bounds of tests/test_chamfer.py:271).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deformationpyramid_tpu.ops import chamfer_fused as jcf
from deformationpyramid_tpu_torch.ops import chamfer as tch
from deformationpyramid_tpu_torch.ops import chamfer_fused as tcf


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


def _clouds(seed, n=230, m=170):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, 3)) * 0.5).astype(np.float32)
    y = (rng.standard_normal((m, 3)) * 0.5).astype(np.float32)
    xv = rng.random(n) > 0.15
    yv = rng.random(m) > 0.15
    return x, y, xv, yv


def _jax_sweep(x, y, xv, yv, trunc):
    """The JAX kernel's outputs on the unpadded rows."""
    w_pad, w2, y_pad, y2, _, _ = jcf._prep(jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(xv), jnp.asarray(yv))
    rsum, csum, cgrad, rmin, rarg = jcf._fused_padded(
        w_pad, w2, y_pad, y2, ty=min(256, y_pad.shape[0]), trunc=trunc,
        interpret=True)
    n = x.shape[0]
    return (float(rsum), float(csum), np.asarray(cgrad)[:n],
            np.asarray(rmin)[:n], np.asarray(rarg)[:n])


@pytest.mark.parametrize("trunc", [1e9, 0.05])
@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_l1_fused_matches_jax(trunc, masked):
    x, y, xv, yv = _clouds(0 if masked else 1)
    if not masked:
        xv[:], yv[:] = True, True
    jv = (jnp.asarray(xv), jnp.asarray(yv)) if masked else (None, None)
    jloss, jgrad = jax.value_and_grad(lambda q: jcf.chamfer_l1_fused(
        q, jnp.asarray(y), *jv, trunc=trunc, interpret=True))(jnp.asarray(x))
    tv = (torch.from_numpy(xv), torch.from_numpy(yv)) if masked \
        else (None, None)
    w = torch.from_numpy(x).requires_grad_(True)
    loss = tcf.chamfer_l1_fused(w, torch.from_numpy(y), *tv, trunc=trunc)
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(jloss)) < 1e-6
    assert np.abs(w.grad.numpy() - np.asarray(jgrad)).max() < 1e-5
    # the same value as the gather path (truncated_chamfer on C1)
    ref = tch.truncated_chamfer(torch.from_numpy(x), torch.from_numpy(y),
                                *tv, trunc=trunc)
    assert abs(loss - float(ref)) < 1e-6

    rsum, csum, cgrad, rmin, rarg = _jax_sweep(x, y, xv, yv, trunc)
    sums, tcgrad, trmin, trarg = tcf.chamfer_fused(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(xv),
        torch.from_numpy(yv), trunc)
    assert abs(float(sums[0]) - rsum) < 1e-5 * max(rsum, 1.0)
    assert abs(float(sums[1]) - csum) < 1e-5 * max(csum, 1.0)
    assert np.abs(tcgrad.numpy() - cgrad).max() < 1e-5
    assert np.abs(trmin.numpy()[xv] - rmin[xv]).max() < 1e-6
    assert np.array_equal(trarg.numpy()[xv], rarg[xv])


def test_chamfer_fused_ties_go_to_the_first_index():
    """A query equidistant from three targets takes the first; a target
    equidistant from two equal query rows lands its term on the first row
    (row 1 gets no column term), as in the JAX kernel."""
    x = np.array([[0, 0, 0], [0, 0, 0], [0, 3, 0]], np.float32)
    y = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0]], np.float32)
    v3 = np.ones(3, bool)
    _, _, cgrad, rmin, rarg = _jax_sweep(x, y, v3, v3, 1e9)
    sums, tcgrad, trmin, trarg = tcf.chamfer_fused(
        torch.from_numpy(x), torch.from_numpy(y))
    assert trarg.tolist() == [0, 0, 2] == rarg.tolist()
    assert np.array_equal(trmin.numpy(), rmin)
    assert not tcgrad[1].any() and tcgrad[0].abs().sum() > 0
    assert np.abs(tcgrad.numpy() - cgrad).max() < 1e-6


def test_fused_chamfer_solver_matches_jax():
    """register's level loop with ``use_fused_chamfer`` (the unfused loop,
    autograd through C12's plain version) against the JAX package's, from
    the same weights and points."""
    from deformationpyramid_tpu.data import synthetic as jsyn
    from deformationpyramid_tpu.models import pyramid as jpyr
    from deformationpyramid_tpu.solve import registration as jreg
    from deformationpyramid_tpu_torch.models import pyramid as tpyr
    from deformationpyramid_tpu_torch.solve import registration as treg

    pyr = dict(m=3, k0=-6, depth=2, width=48)
    solve = dict(iters=40, lr=0.01, max_break_count=15,
                 break_threshold_ratio=0.001, samples=256,
                 use_fused_chamfer=True)
    src, tgt, _ = jsyn.make_pair(n=400, seed=0, deform=0.12)
    rng = np.random.default_rng(0)
    s = (src - src.mean(0))[rng.permutation(400)[:256]]
    t = (tgt - tgt.mean(0))[rng.permutation(400)[:256]]
    v = np.ones(256, bool)
    jcfg = jreg.SolverConfig(pyramid=jpyr.NDPConfig(**pyr), **solve,
                             use_pallas=False)
    tcfg = treg.SolverConfig(pyramid=tpyr.NDPConfig(**pyr), **solve)
    key = jax.random.key(0)
    jparams, jstats = jax.jit(lambda a, b, c: jreg.optimize_pyramid(
        key, a, c, b, c, jcfg))(jnp.asarray(s), jnp.asarray(t),
                                jnp.asarray(v))
    init = tpyr.params_from_numpy(jax.tree.map(
        np.asarray, jpyr.init_pyramid_params(key, jcfg.pyramid)))
    tv = torch.from_numpy(v)
    tparams, tstats = treg.optimize_pyramid(init, torch.from_numpy(s), tv,
                                            torch.from_numpy(t), tv, tcfg)
    assert tstats["iters"].tolist() == np.asarray(jstats["iters"]).tolist()
    assert np.abs(tstats["loss"].numpy()
                  - np.asarray(jstats["loss"])).max() < 5e-3
    jw = jpyr.warp(jparams, jnp.asarray(s), jcfg.pyramid)[0]
    tw = tpyr.warp(tparams, torch.from_numpy(s), tcfg.pyramid)[0]
    assert np.abs(tw.numpy() - np.asarray(jw)).max() < 2e-2
