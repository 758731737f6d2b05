"""The port's fused level loop with the nonrigidity head (``w_reg > 0``),
against the JAX package's ``run_fused_level`` (its kernels in Pallas
interpret mode, the exact pins of tests/test_fused_iteration.py), on the CPU
where the port's kernels run their plain versions.

Tolerances: the nonrigid level loop at the JAX test's horizon (25
iterations; tests/test_fused_iteration.py:538-571): equal iteration count,
loss 1e-4, params and warped points 1e-3. A solve at w_reg 0.2 through
``register_pair``: fused and unfused agree as in JAX's test (:574-598):
equal iterations, losses 5e-3, the warp 2e-2.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deformationpyramid_tpu.models import pyramid as jpyr
from deformationpyramid_tpu.ops import fused_iteration as jfi
from deformationpyramid_tpu.ops import fused_level as jfl
from deformationpyramid_tpu.solve.loop import LoopConfig as JLoopConfig
from deformationpyramid_tpu_torch.models import pyramid as tpyr
from deformationpyramid_tpu_torch.ops import fused_iteration as tfi
from deformationpyramid_tpu_torch.solve.loop import LoopConfig

KW = dict(m=4, k0=-6, depth=3, width=64, rotation_format="axis_angle",
          motion="SE3")
LEVEL = 1
LOOP = dict(lr=0.01, max_break_count=15, break_threshold_ratio=0.001)


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


@pytest.fixture(autouse=True)
def _exact_jax_kernels():
    prev = (jfl._WIDE_MODE, jfi._SWEEP_MXU_DIST, jfi._SWEEP_PACKED)
    jfl._WIDE_MODE = "highest"
    jfi._SWEEP_MXU_DIST = False
    jfi._SWEEP_PACKED = False
    try:
        yield
    finally:
        jfl._WIDE_MODE, jfi._SWEEP_MXU_DIST, jfi._SWEEP_PACKED = prev


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup(seed, nonrigid=False, n=180, m=200):
    """Points, target and the JAX init's weights of level 1 (numpy)."""
    jcfg = jpyr.NDPConfig(**KW, nonrigidity_est=nonrigid)
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((n, 3)) * 0.4).astype(np.float32)
    tgt = (rng.standard_normal((m, 3)) * 0.4).astype(np.float32)
    lvl = jax.tree.map(np.asarray, jpyr.level_params(
        jpyr.init_pyramid_params(jax.random.key(seed), jcfg), LEVEL))
    return jcfg, tpyr.NDPConfig(**KW, nonrigidity_est=nonrigid), pts, tgt, lvl


def _run_both(jcfg, tcfg, pts, tgt, lvl, iters, **kw):
    pv = np.ones(pts.shape[0], bool)
    tv = np.ones(tgt.shape[0], bool)
    jout = jfi.run_fused_level(
        jax.tree.map(jnp.asarray, lvl), jnp.asarray(pts), jnp.asarray(pv),
        jnp.asarray(tgt), jnp.asarray(tv), jnp.int32(LEVEL), jcfg,
        JLoopConfig(iters=iters, **LOOP), interpret=True, **kw)
    tout = tfi.run_fused_level(
        tpyr.params_from_numpy(lvl), _t(pts), _t(pv), _t(tgt), _t(tv), LEVEL,
        tcfg, LoopConfig(iters=iters, **LOOP), **kw)
    return jout, tout


def test_run_fused_level_nonrigid_matches_jax():
    jcfg, tcfg, pts, tgt, lvl = _setup(9, nonrigid=True)
    (jp, jw, jst), (tp, tw, tst) = _run_both(jcfg, tcfg, pts, tgt, lvl, 25,
                                             w_reg=0.3)
    assert int(tst["iters"]) == int(jst["iters"])
    assert abs(float(tst["loss"]) - float(jst["loss"])) < 1e-4
    assert np.abs(tw.numpy() - np.asarray(jw)).max() < 1e-3
    ref = tpyr.params_from_numpy(jax.tree.map(np.asarray, jp))
    assert set(ref) == set(tp) and "nr" in tp
    for k in ref:
        for kk in ref[k]:
            assert (tp[k][kk] - ref[k][kk]).abs().max() < 1e-3, (k, kk)


def test_register_pair_nonrigid_fused_matches_unfused():
    """register_pair at w_reg 0.2 with the nonrigidity head: the fused
    iteration (C2 / C3 with the head, the BCE term in the glue) against the
    unfused loop (autograd through the plain warp), same seed."""
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.solve.registration import (
        SolverConfig, register_pair)

    src, tgt, _ = make_pair(n=300, seed=3, deform=0.12)
    base = dict(pyramid=tpyr.NDPConfig(m=3, k0=-6, depth=3, width=48,
                                       nonrigidity_est=True),
                iters=30, samples=256, w_reg=0.2, **LOOP)
    outs = []
    for fused in (False, True):
        w, st = register_pair(0, _t(src), _t(tgt),
                              SolverConfig(**base, use_fused_iteration=fused))
        outs.append((w.numpy(), st["loss"].numpy(), st["iters"].numpy()))
    assert (outs[0][2] == outs[1][2]).all(), (outs[0][2], outs[1][2])
    assert np.allclose(outs[0][1], outs[1][1], atol=5e-3)
    assert np.abs(outs[0][0] - outs[1][0]).max() < 2e-2
