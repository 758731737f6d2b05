"""The port's whole solve against the JAX package's, on the CPU.

Both solvers start from the same weights (the JAX init, converted with
``params_from_numpy``) and the same pre-sampled, mean-centred points, so
the only differences are float32 summation order and near-tie argmin
flips. Per-level iteration counts must be equal and the full-cloud warp
within 1e-3 (the bound of tests/test_fused_iteration.py for a level loop);
flow metrics within 1e-6; the synthetic data bit-identical.

Over 90 Adam steps float32 trajectories drift chaotically: at k0=-4 or -8
the JAX package's own fused and unfused solves of these inputs already
differ by 1e-3 to 4e-3. The pyramid here uses k0=-6, the configuration of
tests/test_fused_iteration.py, where both packages' solves agree to 5e-5.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deformationpyramid_tpu.data import synthetic as jsyn
from deformationpyramid_tpu.metrics import flow as jflow
from deformationpyramid_tpu.models import pyramid as jpyr
from deformationpyramid_tpu.ops import fused_iteration as jfi
from deformationpyramid_tpu.ops import fused_level as jfl
from deformationpyramid_tpu.solve import registration as jreg
import deformationpyramid_tpu_torch as tdp
from deformationpyramid_tpu_torch.data import synthetic as tsyn
from deformationpyramid_tpu_torch.metrics import flow as tflow
from deformationpyramid_tpu_torch.models import pyramid as tpyr
from deformationpyramid_tpu_torch.solve import registration as treg

PYR = dict(m=3, k0=-6, depth=3, width=32, rotation_format="axis_angle",
           motion="SE3")
SOLVE = dict(iters=30, lr=0.01, max_break_count=15,
             break_threshold_ratio=0.001, samples=200)


@pytest.fixture(autouse=True)
def _exact_jax_kernels():
    """The pins of tests/test_fused_iteration.py for the JAX fused path."""
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


def _inputs(seed=0, n=260):
    src, tgt, _ = jsyn.make_pair(n=n, seed=seed, deform=0.12)
    src_c = src - src.mean(0, keepdims=True)
    tgt_c = tgt - tgt.mean(0, keepdims=True)
    rng = np.random.default_rng(seed)
    s = src_c[rng.permutation(n)[:SOLVE["samples"]]]
    t = tgt_c[rng.permutation(n)[:SOLVE["samples"]]]
    return src_c, s, t


@pytest.mark.parametrize("fused", [False, True])
def test_optimize_pyramid_and_warp_match_jax(fused):
    src_c, s, t = _inputs()
    valid = np.ones(s.shape[0], bool)
    jcfg = jreg.SolverConfig(pyramid=jpyr.NDPConfig(**PYR), **SOLVE,
                             use_pallas=False, use_fused_iteration=fused)
    tcfg = treg.SolverConfig(pyramid=tpyr.NDPConfig(**PYR), **SOLVE,
                             use_fused_iteration=fused)
    key = jax.random.key(7)

    @jax.jit
    def jax_solve(s, t, v, src_c):
        params, stats = jreg.optimize_pyramid(key, s, v, t, v, jcfg)
        return jpyr.warp(params, src_c, jcfg.pyramid)[0], stats

    jwarped, jstats = jax_solve(*map(jnp.asarray, (s, t, valid, src_c)))
    init = jax.jit(jpyr.init_pyramid_params, static_argnums=1)(
        key, jcfg.pyramid)
    tparams, tstats = treg.optimize_pyramid(
        tpyr.params_from_numpy(jax.tree.map(np.asarray, init)), _t(s),
        _t(valid), _t(t), _t(valid), tcfg)
    twarped, _ = tpyr.warp(tparams, _t(src_c), tcfg.pyramid)

    assert tstats["iters"].tolist() == np.asarray(jstats["iters"]).tolist()
    assert np.abs(tstats["loss"].numpy() - np.asarray(jstats["loss"])
                  ).max() < 1e-4
    assert np.abs(twarped.numpy() - np.asarray(jwarped)).max() < 1e-3


def test_flow_metrics_match_jax():
    rng = np.random.default_rng(3)
    gt = (rng.standard_normal((300, 3)) * 0.05).astype(np.float32)
    pred = gt + (rng.standard_normal((300, 3)) * 0.02).astype(np.float32)
    overlap = rng.random(300) > 0.3
    valid = rng.random(300) > 0.1
    for ov, va in ((None, None), (overlap, None), (overlap, valid)):
        got = tflow.compute_flow_metrics(
            _t(pred), _t(gt), None if ov is None else _t(ov),
            None if va is None else _t(va))
        ref = jflow.compute_flow_metrics(
            jnp.asarray(pred), jnp.asarray(gt),
            None if ov is None else jnp.asarray(ov),
            None if va is None else jnp.asarray(va))
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert abs(float(got[k]) - float(ref[k])) < 1e-6 * max(
                1.0, abs(float(ref[k]))), k
    got = tflow.metric_sums(_t(pred), _t(gt), _t(valid))
    ref = jflow.metric_sums(jnp.asarray(pred), jnp.asarray(gt),
                            jnp.asarray(valid))
    for k in ref:
        assert abs(float(got[k]) - float(ref[k])) < 1e-6 * max(
            1.0, abs(float(ref[k]))), k


def test_make_batch_bit_identical():
    for a, b in zip(tsyn.make_batch(3, n=100, seed=100, deform=0.12),
                    jsyn.make_batch(3, n=100, seed=100, deform=0.12)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tsyn.make_pair(50, seed=2, rigid=True),
                    jsyn.make_pair(50, seed=2, rigid=True)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("fused", [False, True])
def test_register_pair_runs_on_cpu(fused):
    src, tgt, flow = tsyn.make_pair(n=220, seed=4, deform=0.12)
    cfg = treg.SolverConfig(pyramid=tpyr.NDPConfig(**PYR), **SOLVE,
                            use_fused_iteration=fused)
    warped, stats = tdp.register_pair(11, _t(src), _t(tgt), cfg)
    assert warped.shape == (220, 3) and torch.isfinite(warped).all()
    assert stats["iters"].shape == (3,) and (stats["iters"] >= 1).all()
    # the same seed gives the same solve
    again, _ = tdp.make_register_fn(cfg)(11, _t(src), _t(tgt))
    assert torch.equal(again, warped)
    # the solve moves the cloud toward the target
    epe = (warped - _t(src) - _t(flow)).norm(dim=-1).mean()
    assert epe < _t(flow).norm(dim=-1).mean()


def test_register_batch_and_padding_masks():
    srcs, tgts, _ = tsyn.make_batch(2, n=150, seed=5, deform=0.12)
    cfg = treg.SolverConfig(pyramid=tpyr.NDPConfig(**PYR), iters=8,
                            samples=100, use_fused_iteration=True)
    valid = np.ones((2, 150), bool)
    valid[1, 120:] = False
    warped, stats = tdp.register_batch([0, 1], _t(srcs), _t(tgts), cfg,
                                       _t(valid), _t(valid))
    assert warped.shape == (2, 150, 3) and torch.isfinite(warped).all()
    assert stats["iters"].shape == (2, 3)
    single, _ = tdp.register_pair(1, _t(srcs[1]), _t(tgts[1]), cfg,
                                  _t(valid[1]), _t(valid[1]))
    assert torch.equal(single, warped[1])
