"""Parity of the PyTorch port's rotations and pyramid with the JAX package.

Inputs and weights come from numpy with a fixed seed, in the JAX package's
parameter layout, and reach the port through ``params_from_numpy``.
Tolerances: 1e-5 absolute on warped points and rotation matrices (float32
on both sides, only the summation order differs), exact equality where
nothing is computed.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deformationpyramid_tpu.geometry import rotations as jrot
from deformationpyramid_tpu.models import pyramid as jpyr
from deformationpyramid_tpu_torch.geometry import rotations as trot
from deformationpyramid_tpu_torch.models import pyramid as tpyr

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(a, b, tol=TOL):
    a = np.asarray(a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                   else a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err < tol, err


@pytest.mark.parametrize("name,dim", [
    ("axis_angle_to_SO3", 3), ("euler_to_SO3", 3), ("quaternion_to_SO3", 4),
    ("normalize_quaternion", 4), ("sixd_to_SO3", 6), ("skew", 3)])
def test_rotation_converters(name, dim):
    rng = np.random.default_rng(0)
    r = (rng.standard_normal((64, dim)) * 0.7).astype(np.float32)
    _close(getattr(trot, name)(_t(r)),
           jax.jit(getattr(jrot, name))(jnp.asarray(r)))


def test_rotate_axis_angle_and_apply_rotation():
    rng = np.random.default_rng(1)
    r = (rng.standard_normal((64, 3)) * 0.5).astype(np.float32)
    r[0] = 0.0  # the 1e-12 floor
    r[1] = 1e-4
    x = rng.standard_normal((64, 3)).astype(np.float32)
    _close(trot.rotate_axis_angle(_t(r), _t(x)),
           jrot.rotate_axis_angle(jnp.asarray(r), jnp.asarray(x)))
    R = jrot.axis_angle_to_SO3(jnp.asarray(r))
    _close(trot.apply_rotation(_t(R), _t(x)),
           jrot.apply_rotation(R, jnp.asarray(x)))
    _close(trot._copysign(_t(r[:, 0]), _t(r[:, 1])),
           jrot._copysign(jnp.asarray(r[:, 0]), jnp.asarray(r[:, 1])), 1e-30)


def _np_params(cfg_kwargs, seed=0):
    """Random weights in the JAX package's stacked layout, made with numpy
    (the tree structure and shapes are the JAX init's, read without
    compiling it)."""
    jcfg = jpyr.NDPConfig(**cfg_kwargs)
    shapes = jax.eval_shape(lambda k: jpyr.init_pyramid_params(k, jcfg),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (rng.uniform(-1, 1, a.shape) * 0.3).astype(np.float32),
        shapes)
    return jcfg, tpyr.NDPConfig(**cfg_kwargs), params


def _jax_warps(jcfg, params, x):
    """Every level's warp of x and the full warp, in one JAX compile."""
    def f(p, x):
        levels = [jpyr.level_warp(jpyr.level_params(p, lvl), x, lvl, jcfg)
                  for lvl in range(jcfg.m)]
        return levels, jpyr.warp(p, x, jcfg)
    return jax.jit(f)(params, jnp.asarray(x))


@pytest.mark.parametrize("motion", ["SE3", "Sim3", "sflow"])
@pytest.mark.parametrize("rot", ["axis_angle", "euler", "quaternion", "6D"])
def test_level_warp_and_warp(motion, rot):
    kw = dict(m=3, k0=-4, depth=3, width=32, motion=motion,
              rotation_format=rot)
    jcfg, tcfg, params = _np_params(kw)
    tparams = tpyr.params_from_numpy(params)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((150, 3)) * 0.5).astype(np.float32)
    jlevels, (jw, _) = _jax_warps(jcfg, params, x)
    for lvl in range(3):
        tw, _ = tpyr.level_warp(tpyr.level_params(tparams, lvl), _t(x), lvl,
                                tcfg)
        _close(tw, jlevels[lvl][0])
    tw, _ = tpyr.warp(tparams, _t(x), tcfg)
    _close(tw, jw)


@pytest.mark.parametrize("motion,rot", [
    ("SE3", "axis_angle"), ("Sim3", "axis_angle"), ("sflow", "axis_angle"),
    ("SE3", "euler"), ("Sim3", "quaternion"), ("SE3", "6D")])
def test_transposed_layout_matches_jax(motion, rot):
    """The [3, N] functions (the JAX package's TPU layout) against JAX's,
    and against the port's own [N, 3] warp (the same function)."""
    kw = dict(m=3, k0=-4, depth=3, width=32, motion=motion,
              rotation_format=rot)
    jcfg, tcfg, params = _np_params(kw, seed=4)
    tparams = tpyr.params_from_numpy(params)
    rng = np.random.default_rng(5)
    xt = (rng.standard_normal((3, 150)) * 0.5).astype(np.float32)

    def f(p, xt):
        return [(jpyr.posenc_t(xt, lvl, jcfg.k0),
                 jpyr.level_features_t(jpyr.level_params(p, lvl), xt, lvl,
                                       jcfg),
                 jpyr.level_warp_t(jpyr.level_params(p, lvl), xt, lvl, jcfg))
                for lvl in range(jcfg.m)]

    ref = jax.jit(f)(params, jnp.asarray(xt))
    for lvl, (jpe, jfea, jw) in enumerate(ref):
        lp = tpyr.level_params(tparams, lvl)
        _close(tpyr.posenc_t(_t(xt), lvl, tcfg.k0), jpe)
        _close(tpyr.level_features_t(lp, _t(xt), lvl, tcfg), jfea)
        tw = tpyr.level_warp_t(lp, _t(xt), lvl, tcfg)
        _close(tw, jw)
        _close(tw.T, tpyr.level_warp(lp, _t(xt.T), lvl, tcfg)[0].detach())
    r = (rng.standard_normal((3, 64)) * 0.5).astype(np.float32)
    r[:, 0] = 0.0  # the 1e-12 floor
    _close(trot.rotate_axis_angle_t(_t(r), _t(xt[:, :64])),
           jrot.rotate_axis_angle_t(jnp.asarray(r), jnp.asarray(xt[:, :64])))
    with pytest.raises(ValueError):
        tpyr.level_warp_t(tpyr.level_params(tparams, 0), _t(xt), 0,
                          tpyr.NDPConfig(**kw, nonrigidity_est=True))


@pytest.mark.parametrize("motion,rot,nonrigid", [
    ("SE3", "axis_angle", True), ("Sim3", "quaternion", False),
    ("sflow", "axis_angle", True)])
def test_level_warp_slot_axis_matches_jax_per_slot(motion, rot, nonrigid):
    """level_warp with a leading slot axis (the streaming solver's form:
    each slot its own level's parameters and a [B] level tensor, level 0
    ungated) against JAX's level_warp on each slot alone."""
    kw = dict(m=4, k0=-4, depth=3, width=32, motion=motion,
              rotation_format=rot, nonrigidity_est=nonrigid)
    jcfg, tcfg, params = _np_params(kw, seed=7)
    tparams = tpyr.params_from_numpy(params)
    rng = np.random.default_rng(8)
    levels = [0, 3, 1, 2]
    x = (rng.standard_normal((4, 90, 3)) * 0.5).astype(np.float32)
    lvl = torch.tensor(levels, dtype=torch.int32)
    slots = tpyr.tree_map(lambda a: a[lvl.long()], tparams)
    tw, tnr = tpyr.level_warp(slots, _t(x), lvl, tcfg)
    assert tw.shape == (4, 90, 3)
    for b, level in enumerate(levels):
        jw, jnr = jpyr.level_warp(jpyr.level_params(params, level),
                                  jnp.asarray(x[b]), level, jcfg)
        _close(tw[b], jw)
        if nonrigid:
            _close(tnr[b], jnr)
        else:
            assert tnr is None


def test_nonrigidity_gate():
    kw = dict(m=3, k0=-4, depth=2, width=16, nonrigidity_est=True)
    jcfg, tcfg, params = _np_params(kw, seed=3)
    tparams = tpyr.params_from_numpy(params)
    x = np.random.default_rng(3).standard_normal((40, 3)).astype(np.float32)
    jlevels, _ = _jax_warps(jcfg, params, x)
    for lvl in range(3):
        jw, jnr = jlevels[lvl]
        tw, tnr = tpyr.level_warp(tpyr.level_params(tparams, lvl), _t(x),
                                  lvl, tcfg)
        _close(tw, jw)
        _close(tnr, jnr)


def test_params_from_numpy_roundtrip_exact():
    _, _, npy = _np_params(dict(m=2, depth=3, width=16, motion="Sim3",
                                nonrigidity_est=True))
    back = tpyr.params_to_numpy(tpyr.params_from_numpy(npy))
    assert jax.tree.structure(back) == jax.tree.structure(npy)
    for a, b in zip(jax.tree.leaves(npy), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_ravel_matches_jax_ravel_pytree():
    """The flat level layout (the kernels' and the Adam loop's) is JAX's
    ravel_pytree order, bit for bit, and unravel inverts it."""
    import jax.flatten_util

    _, tcfg, params = _np_params(dict(m=2, depth=3, width=16))
    lvl = jax.tree.map(lambda a: a[1], params)
    jflat = jax.flatten_util.ravel_pytree(lvl)[0]
    tlvl = tpyr.params_from_numpy(lvl)
    flat = tpyr.ravel(tlvl)
    assert np.array_equal(flat.numpy(), np.asarray(jflat))
    back = tpyr.unravel(flat, tpyr.level_shapes(tcfg))
    for k in tlvl:
        for kk in tlvl[k]:
            assert torch.equal(back[k][kk], tlvl[k][kk])


@pytest.mark.parametrize("motion,nr", [("SE3", False), ("Sim3", True),
                                       ("sflow", False)])
def test_init_pyramid_params_matches_jax_layout(motion, nr):
    """Same tree, shapes and dtypes as the JAX init; xavier/torch-default
    bounds hold (the random streams differ by design)."""
    kw = dict(m=2, depth=3, width=24, motion=motion, nonrigidity_est=nr)
    jshapes = jax.eval_shape(
        lambda k: jpyr.init_pyramid_params(k, jpyr.NDPConfig(**kw)),
        jax.random.key(0))
    tcfg = tpyr.NDPConfig(**kw)
    tparams = tpyr.init_pyramid_params(torch.Generator().manual_seed(0), tcfg)
    npy = tpyr.params_to_numpy(tparams)
    assert jax.tree.structure(npy) == jax.tree.structure(jshapes)
    for a, b in zip(jax.tree.leaves(npy), jax.tree.leaves(jshapes)):
        assert a.shape == b.shape and a.dtype == np.float32
    w = tparams["input"]["w"]
    assert w.abs().max() <= (6.0 / (6 + 24)) ** 0.5
    assert tparams["input"]["b"].abs().max() <= 1 / 6 ** 0.5
    again = tpyr.init_pyramid_params(torch.Generator().manual_seed(0), tcfg)
    assert torch.equal(again["trn"]["w"], tparams["trn"]["w"])
