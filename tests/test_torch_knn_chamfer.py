"""Parity of the port's 1-NN search and truncated chamfer with the JAX
package (``ops/knn.py``, ``ops/chamfer.py``), on the CPU, where the port's
``nn_argmin_dual`` runs the plain version of kernel C1.

Index rule: the port selects on exact differences, the JAX XLA path on the
expanded |x|^2 + |y|^2 - 2 x.y, so an index may differ only on a near-tie
whose relative distance gap is < 3e-4 (the rule of
tests/test_fused_iteration.py). Tolerances: distances 1e-5, chamfer value
1e-6, chamfer gradient 1e-5 (float32 on both sides).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deformationpyramid_tpu.ops import chamfer as jch
from deformationpyramid_tpu.ops import knn as jknn
from deformationpyramid_tpu_torch.ops import chamfer as tch
from deformationpyramid_tpu_torch.ops import knn as tknn


def _t(a):
    return torch.from_numpy(np.array(a))


def _clouds(seed, n=230, m=170):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, 3)) * 0.5).astype(np.float32)
    y = (rng.standard_normal((m, 3)) * 0.5).astype(np.float32)
    xv = rng.random(n) > 0.15
    yv = rng.random(m) > 0.15
    return x, y, xv, yv


def near_tie_ok(idx, ref_idx, q, db):
    """Indices equal, or a flip whose distance exceeds the true minimum by
    less than 3e-4 relative."""
    idx, ref_idx = np.asarray(idx), np.asarray(ref_idx)
    flips = idx != ref_idx
    if not flips.any():
        return
    d_got = ((q[flips] - db[idx[flips]]) ** 2).sum(-1)
    d_ref = ((q[flips] - db[ref_idx[flips]]) ** 2).sum(-1)
    rel = np.abs(d_got - d_ref) / np.maximum(d_ref, 1e-30)
    assert rel.max() < 3e-4, rel.max()


@pytest.mark.parametrize("masked", [False, True])
def test_nn_argmin_dual_matches_xla(masked):
    x, y, xv, yv = _clouds(0)
    if not masked:
        xv = np.ones_like(xv)
        yv = np.ones_like(yv)
    sq_x, idx_x, sq_y, idx_y = tknn.nn_argmin_dual(
        _t(x), _t(y), _t(xv) if masked else None, _t(yv) if masked else None)
    ref = jax.jit(jknn.nn_argmin_xla)
    rsq_x, ridx_x = ref(jnp.asarray(x), jnp.asarray(y), jnp.asarray(yv))
    rsq_y, ridx_y = ref(jnp.asarray(y), jnp.asarray(x), jnp.asarray(xv))
    near_tie_ok(idx_x.numpy(), ridx_x, x, y)
    near_tie_ok(idx_y.numpy(), ridx_y, y, x)
    assert np.abs(sq_x.numpy() - np.asarray(rsq_x)).max() < 1e-5
    assert np.abs(sq_y.numpy() - np.asarray(rsq_y)).max() < 1e-5
    # invalid rows never win
    assert yv[idx_x.numpy()].all() and xv[idx_y.numpy()].all()


def test_nn_argmin_dual_first_index_ties_and_exact_distances():
    """Duplicated database points: the first index wins in both
    directions, and distances are exact (no cancellation floor)."""
    rng = np.random.default_rng(4)
    y = rng.standard_normal((40, 3)).astype(np.float32) * 100.0
    y = np.concatenate([y, y])          # every point twice
    x = y[:40] + np.float32(1e-3)
    sq_x, idx_x, sq_y, idx_y = tknn.nn_argmin_dual(_t(x), _t(y))
    assert (idx_x.numpy() == np.arange(40)).all()
    assert (idx_y.numpy() == np.concatenate([np.arange(40)] * 2)).all()
    exact = ((x - y[:40]) ** 2).sum(-1)
    assert np.abs(sq_x.numpy() - exact).max() < 1e-9


def test_nn_argmin_matches_xla():
    x, y, _, yv = _clouds(1)
    sq, idx = tknn.nn_argmin(_t(x), _t(y), _t(yv))
    rsq, ridx = jax.jit(jknn.nn_argmin_xla)(jnp.asarray(x), jnp.asarray(y),
                                            jnp.asarray(yv))
    near_tie_ok(idx.numpy(), ridx, x, y)
    assert np.abs(sq.numpy() - np.asarray(rsq)).max() < 1e-5


def _jax_chamfer(trunc, masked):
    def f(x, y, xv, yv):
        return jch.truncated_chamfer(x, y, x_valid=xv if masked else None,
                                     y_valid=yv if masked else None,
                                     trunc=trunc, use_pallas=False)
    return jax.jit(jax.value_and_grad(f, argnums=(0, 1)))


@pytest.mark.parametrize("trunc", [1e9, 0.25])
@pytest.mark.parametrize("masked", [False, True])
def test_truncated_chamfer_value_and_grad(trunc, masked):
    x, y, xv, yv = _clouds(2)
    tx = _t(x).requires_grad_(True)
    ty = _t(y).requires_grad_(True)
    val = tch.truncated_chamfer(tx, ty, _t(xv) if masked else None,
                                _t(yv) if masked else None, trunc=trunc)
    gx, gy = torch.autograd.grad(val, (tx, ty))
    rval, (rgx, rgy) = _jax_chamfer(trunc, masked)(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(xv), jnp.asarray(yv))
    assert abs(float(val.detach()) - float(rval)) < 1e-6
    assert np.abs(gx.numpy() - np.asarray(rgx)).max() < 1e-5
    assert np.abs(gy.numpy() - np.asarray(rgy)).max() < 1e-5


def test_truncated_chamfer_normals_term():
    x, y, xv, yv = _clouds(3)
    rng = np.random.default_rng(5)
    xn = rng.standard_normal(x.shape).astype(np.float32)
    yn = rng.standard_normal(y.shape).astype(np.float32)
    xn[0] = 0.0   # the 1e-6 norm clamp
    dist, norm = tch.truncated_chamfer(_t(x), _t(y), _t(xv), _t(yv),
                                       trunc=0.25, x_normals=_t(xn),
                                       y_normals=_t(yn), return_normals=True)
    rdist, rnorm = jax.jit(lambda *a: jch.truncated_chamfer(
        a[0], a[1], x_valid=a[2], y_valid=a[3], trunc=0.25, use_pallas=False,
        x_normals=a[4], y_normals=a[5], return_normals=True))(
        *map(jnp.asarray, (x, y, xv, yv, xn, yn)))
    assert abs(float(dist) - float(rdist)) < 1e-6
    assert abs(float(norm) - float(rnorm)) < 1e-6
    with pytest.raises(ValueError):
        tch.truncated_chamfer(_t(x), _t(y), return_normals=True)


@pytest.mark.parametrize("reduction", ["mean", "sum", None])
def test_batched_truncated_chamfer(reduction):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((3, 60, 3)) * 0.5).astype(np.float32)
    y = (rng.standard_normal((3, 50, 3)) * 0.5).astype(np.float32)
    xl = np.array([60, 41, 30], np.int32)
    yl = np.array([50, 50, 22], np.int32)
    w = np.array([1.0, 0.5, 2.0], np.float32)
    got = tch.batched_truncated_chamfer(_t(x), _t(y), _t(xl), _t(yl), _t(w),
                                        trunc=0.25, batch_reduction=reduction)
    ref = jax.jit(lambda *a: jch.batched_truncated_chamfer(
        *a, trunc=0.25, batch_reduction=reduction, use_pallas=False))(
        *map(jnp.asarray, (x, y, xl, yl, w)))
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-6
