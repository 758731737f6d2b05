"""The port's renderer and the losses built on it (``ops/render.py``:
``render_depth_silhouette``, ``silhouette_cost``, ``point_2_plane_distance``)
against the JAX package's, on the CPU, at the JAX tests' 48 x 64
``RenderConfig``, on the same numpy inputs.

Tolerances: values 1e-6; gradients 1e-5, on inputs without z-ties (no two
points of one pixel at one depth). At a tie both packages split the
pixel's gradient evenly among the tied points (torch's ``amin`` backward,
JAX's scatter-min JVP): one case holds that too.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deformationpyramid_tpu.ops import render as jrender
from deformationpyramid_tpu_torch import losses as tlosses
from deformationpyramid_tpu_torch.ops import render as trender

K = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]], np.float32)
JRC = jrender.RenderConfig(height=48, width=64)
TRC = trender.RenderConfig(height=48, width=64)


def _cloud(n, seed):
    """Points in and around the view: some off the image, some behind the
    camera, depths distinct (no z-ties)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.4, 0.4, n),
                    rng.uniform(1.0, 2.0, n)], 1)
    pts[:5, 2] = -pts[:5, 2]
    pts[5:8, :2] *= 10.0
    return pts.astype(np.float32)


def _max_err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("masked", [False, True])
def test_render_matches_jax(masked):
    pts = _cloud(400, 0)
    valid = np.random.default_rng(1).random(400) > 0.3 if masked else None
    jd, js = jrender.render_depth_silhouette(
        jnp.asarray(pts), jnp.asarray(K), JRC,
        None if valid is None else jnp.asarray(valid))
    td, ts = trender.render_depth_silhouette(
        torch.from_numpy(pts), torch.from_numpy(K), TRC,
        None if valid is None else torch.from_numpy(valid))
    assert td.shape == ts.shape == (48, 64)
    assert _max_err(td, jd) <= 1e-6 and _max_err(ts, js) == 0.0
    assert 50 < float(ts.sum()) < 400


def test_render_gradient_matches_jax():
    pts = _cloud(400, 2)
    w = np.random.default_rng(3).standard_normal((48, 64)).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jrender.render_depth_silhouette(
        p, jnp.asarray(K), JRC)[0] * w))(jnp.asarray(pts))
    tp = torch.from_numpy(pts).requires_grad_(True)
    (tg,) = torch.autograd.grad(torch.sum(trender.render_depth_silhouette(
        tp, torch.from_numpy(K), TRC)[0] * torch.from_numpy(w)), tp)
    assert _max_err(tg, jg) <= 1e-5
    assert float(tg[:, 2].abs().sum()) > 0 and float(tg[:, :2].abs().max()) == 0


def test_render_tie_splits_the_gradient_in_both():
    pts = np.array([[0.0, 0.0, 2.0], [0.001, 0.0, 2.0], [0.0, 0.0, 3.0]],
                   np.float32)
    jg = jax.grad(lambda p: jrender.render_depth_silhouette(
        p, jnp.asarray(K), JRC)[0][24, 32])(jnp.asarray(pts))
    tp = torch.from_numpy(pts).requires_grad_(True)
    (tg,) = torch.autograd.grad(trender.render_depth_silhouette(
        tp, torch.from_numpy(K), TRC)[0][24, 32], tp)
    assert tg[:, 2].tolist() == [0.5, 0.5, 0.0]
    assert _max_err(tg, jg) == 0.0


@pytest.mark.parametrize("shift", [0.0, 0.05, 0.3])
def test_silhouette_cost_matches_jax(shift):
    y = _cloud(300, 4)
    rng = np.random.default_rng(5)
    x = (y + np.array([shift, 0.0, 0.0])
         + rng.normal(0, 0.02, y.shape)).astype(np.float32)
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jrender.silhouette_cost(
        p, jnp.asarray(y), jnp.asarray(K), JRC)))(jnp.asarray(x))
    tp = torch.from_numpy(x).requires_grad_(True)
    tv = tlosses.silhouette_cost(tp, torch.from_numpy(y), torch.from_numpy(K),
                                 TRC)
    (tg,) = torch.autograd.grad(tv, tp)
    tv = tv.detach()
    assert abs(float(tv) - float(jv)) <= 1e-6
    assert _max_err(tg, jg) <= 1e-5
    if shift > 0:
        assert float(tv) > 0


def test_point_2_plane_distance_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.uniform(-0.5, 0.5, (150, 3)).astype(np.float32)
    y = (x[rng.permutation(150)[:120]]
         + rng.normal(0, 0.03, (120, 3))).astype(np.float32)
    nx = rng.normal(size=(150, 3))
    ny = rng.normal(size=(120, 3))
    nx = (nx / np.linalg.norm(nx, axis=1, keepdims=True)).astype(np.float32)
    ny = (ny / np.linalg.norm(ny, axis=1, keepdims=True)).astype(np.float32)
    args = (x, y, nx, ny)
    jout = jrender.point_2_plane_distance(*map(jnp.asarray, args),
                                          use_pallas=False)
    jg = jax.jit(jax.grad(lambda *a: jrender.point_2_plane_distance(
        *a, use_pallas=False)[0], argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    tout = tlosses.point_2_plane_distance(*ts)
    tg = torch.autograd.grad(tout[0], ts)
    for a, b in zip(tout, jout):
        assert abs(float(a.detach()) - float(b)) <= 1e-6
    for a, b in zip(tg, jg):
        assert _max_err(a, b) <= 1e-5
