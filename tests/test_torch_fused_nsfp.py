"""Parity of the port's fused NSFP iteration (``ops/fused_iteration.py``:
C10 ``nsfp_fwd``, C11 ``nsfp_bwd``, ``run_fused_nsfp``) with the JAX
package's two-kernel iteration at ``model="nsfp"``, on the CPU.

The port's wrappers run their plain versions here; the JAX kernels run in
Pallas interpret mode with exact wide matmuls and the unpacked sweep, as
tests/test_fused_iteration.py:673 runs them. Tolerances: the flat layout
bit for bit; warped points 1e-5; one Adam step (params, moments) 1e-5; a
5-iteration loop at width 64, 5 layers: equal iteration count, loss 1e-4,
parameters 2e-2 (the JAX test's own band: NSFP's flow starts O(1), so
float32 trajectories part within a few Adam steps of +-lr).
"""
import numpy as np
import pytest

import jax
import jax.flatten_util
import jax.numpy as jnp
import torch

from deformationpyramid_tpu.models import baselines as jbase
from deformationpyramid_tpu.ops import fused_iteration as jfi
from deformationpyramid_tpu.ops import fused_level as jfl
from deformationpyramid_tpu.solve.loop import LoopConfig as JLoopConfig
from deformationpyramid_tpu_torch.models import baselines as tbase
from deformationpyramid_tpu_torch.models import pyramid as tpyr
from deformationpyramid_tpu_torch.ops import fused_iteration as tfi
from deformationpyramid_tpu_torch.solve import baselines as tsolve
from deformationpyramid_tpu_torch.solve.loop import LoopConfig

KW = dict(width=64, n_layers=5)
JN, TN = jbase.NSFPConfig(**KW), tbase.NSFPConfig(**KW)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is as fast as many,
    and parallel test workers do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _setup(n=180, m=200, seed=6):
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((n, 3)) * 0.4).astype(np.float32)
    tgt = (rng.standard_normal((m, 3)) * 0.4).astype(np.float32)
    params = jax.tree.map(np.asarray,
                          jbase.init_nsfp_params(jax.random.key(seed), JN))
    return pts, tgt, params


def _pad(pts, tgt):
    n, m = pts.shape[0], tgt.shape[0]
    n_pad = jfi._round_up(max(n, 128), 128)
    tm = min(512, jfi._round_up(max(m, 8), 8))
    m_pad = jfi._round_up(max(m, tm), tm)
    xt_pad = jnp.zeros((3, n_pad), jnp.float32).at[:, :n].set(pts.T)
    xbig = jnp.where(jnp.arange(n_pad) < n, 0.0, jfi._BIG)[None, :]
    yc = jnp.zeros((m_pad, 3), jnp.float32).at[:m].set(tgt)
    ysqb = jnp.where(jnp.arange(m_pad) < m, jnp.sum(yc * yc, axis=-1),
                     jfi._BIG)[:, None]
    return xt_pad, xbig, yc, ysqb, tm, n_pad


def test_flat_layout_is_ravel_pytree():
    _, _, params = _setup()
    jflat = np.asarray(jax.flatten_util.ravel_pytree(params)[0])
    flat = tfi.nsfp_params_to_flat(tpyr.params_from_numpy(params))
    assert flat.shape == (tfi.nsfp_param_count(TN),)
    assert np.array_equal(flat.numpy(), jflat)
    back = tfi.nsfp_flat_to_params(flat, TN)
    for a, b in zip(back, params):
        assert np.array_equal(a["w"].numpy(), b["w"])
        assert np.array_equal(a["b"].numpy(), b["b"])
    assert tfi.nsfp_param_count(tbase.NSFPConfig()) == 116483


def test_supports_fused_nsfp_gate():
    """C10 / C11 cover ReLU, >= 2 layers, a width that is a multiple of 4
    up to 256. C11's 16-point tile at 9 x 128 takes 87,424 bytes of shared
    memory: 10 [16][136] buffers and the points and cotangents."""
    assert tfi.supports_fused_nsfp(tbase.NSFPConfig())
    assert tfi.supports_fused_nsfp(TN)
    assert tfi.nsfp_bwd_smem(tbase.NSFPConfig()) == 87424
    for kw in (dict(n_layers=2), dict(width=256, n_layers=12),
               dict(n_layers=20)):
        assert tfi.supports_fused_nsfp(tbase.NSFPConfig(**kw)), kw
    for kw in (dict(act="sigmoid"), dict(width=130), dict(width=512),
               dict(width=260), dict(n_layers=1)):
        assert not tfi.supports_fused_nsfp(tbase.NSFPConfig(**kw)), kw
    with pytest.raises(ValueError):
        tfi.run_fused_nsfp([], torch.zeros(4, 3), torch.ones(4, dtype=bool),
                           torch.zeros(4, 3), torch.ones(4, dtype=bool),
                           LoopConfig(), tbase.NSFPConfig(act="sigmoid"))


def test_supports_fused_nsfp_covers_the_first_tiles_configurations():
    """Every configuration that the first C11 (one thread a unit, 16
    points of 20 floats a unit, 4 (6 * 16 + (L + 1) w 20) bytes within a
    block) covered is still covered. Where C11's tensor-core buffers do not
    fit a block (narrow nets many layers deep: widths 4 and 20 from 90
    layers, 36 and 48 from 50), they go to device memory."""
    spilled = 0
    for w in range(4, tfi.MAX_WIDTH + 1, 4):
        depth = 2
        while 4 * (6 * 16 + (depth + 1) * w * 20) <= tfi.SMEM_LIMIT:
            ncfg = tbase.NSFPConfig(width=w, n_layers=depth)
            assert tfi.supports_fused_nsfp(ncfg), (w, depth)
            spilled += tfi.nsfp_bwd_smem(ncfg) > tfi.SMEM_LIMIT
            depth += 1
    assert spilled > 0
    assert tfi.nsfp_bwd_smem(tbase.NSFPConfig(width=128, n_layers=25)) \
        <= tfi.SMEM_LIMIT


@pytest.mark.parametrize("n,fwd,bwd", [(1, 16, 16), (15, 16, 16),
                                       (16, 16, 16), (2000, 16, 16),
                                       (6000, 48, 32), (30000, 208, 32)])
def test_nsfp_tiles(n, fwd, bwd):
    """C10's and C11's tiles at 9 x 128 (``nsfp_fwd_tile``,
    ``nsfp_bwd_tile``): C3's one-wave rule, whole 16-point m-tiles, as few
    a block as keep the grid within one block an SM, fewer where a block's
    shared memory would not fit (C11 from 48 points on, C10 from 224)."""
    ncfg = tbase.NSFPConfig()
    assert tfi.nsfp_fwd_tile(n, ncfg) == fwd
    assert tfi.nsfp_bwd_tile(n, ncfg) == bwd
    assert tfi.nsfp_fwd_smem(ncfg, fwd) <= tfi.SMEM_LIMIT
    assert tfi.nsfp_bwd_smem(ncfg, bwd) <= tfi.SMEM_LIMIT
    for tile, smem in ((fwd, tfi.nsfp_fwd_smem), (bwd, tfi.nsfp_bwd_smem)):
        assert -(-n // tile) <= tfi.C3_MAX_BLOCKS \
            or smem(ncfg, tile + 16) > tfi.SMEM_LIMIT


@pytest.mark.parametrize("kw,n,rows,tile,spill", [
    (dict(), 2000, 125, 16, False), (dict(), 333, 21, 16, False),
    (dict(), 6000, 188, 32, False), (dict(width=20, n_layers=100), 50, 4,
                                     16, True)])
def test_nsfp_bwd_allocates_one_row_a_block(monkeypatch, kw, n, rows, tile,
                                            spill):
    """The CUDA branch of ``nsfp_bwd`` (its launch recorded here): one
    partial row of P values for each block of ``nsfp_bwd_tile`` points,
    and a device-memory scratch of (L + 1) [tile][ld] buffers a block only
    where they exceed a block's shared memory."""
    ncfg = tbase.NSFPConfig(**kw)
    seen = []
    monkeypatch.setattr(tfi, "on_cpu", lambda *t: False)
    monkeypatch.setattr(tfi, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(tfi.NSFP_BWD, "launch", lambda *a: seen.append(a))
    flat = torch.zeros(tfi.nsfp_param_count(ncfg))
    part = tfi.nsfp_bwd(flat, torch.zeros(n, 3), torch.zeros(n, 3), ncfg)
    assert part.shape == (rows, flat.numel())
    (args,) = seen
    assert args[3:9] == (n, ncfg.width, ncfg.n_layers, part.data_ptr(),
                         rows, tile)
    assert (args[9] is not None) == spill


def test_nsfp_fwd_plain_matches_fwd_sweep_call():
    """C10 + C1 (plain) against JAX kernel 1 at model="nsfp"."""
    pts, tgt, params = _setup()
    xt_pad, xbig, yc, ysqb, tm, _ = _pad(pts, tgt)
    warped_t, cmin, _, rmin, _ = jfi._fwd_sweep_call(
        jnp.zeros((1, 1), jnp.float32), xt_pad, xbig, yc, ysqb,
        jfi.nsfp_params_to_t(jax.tree.map(jnp.asarray, params)),
        mlp_scale=0.0, tm=tm, interpret=True, model="nsfp")
    n, m = pts.shape[0], tgt.shape[0]
    flat = tfi.nsfp_params_to_flat(tpyr.params_from_numpy(params))
    warped = tfi.nsfp_fwd(flat, _t(pts), TN)
    assert np.abs(warped.numpy() - np.asarray(warped_t).T[:n]).max() < 1e-5
    sq_x, _, sq_y, _ = tfi.nn_argmin_dual(warped, _t(tgt))
    assert np.abs(sq_x.numpy() - np.asarray(cmin)[0, :n]).max() < 1e-5
    assert np.abs(sq_y.numpy() - np.asarray(rmin)[:m, 0]).max() < 1e-5


def test_nsfp_bwd_plain_matches_bwd_adam_call():
    """C11 + C4 (plain) against JAX kernel 2 at model="nsfp": one Adam
    step from zero moments within 1e-5."""
    pts, tgt, params = _setup(seed=2)
    xt_pad, _, _, _, _, n_pad = _pad(pts, tgt)
    n = pts.shape[0]
    g = (np.random.default_rng(3).standard_normal((n, 3)) * 0.1
         ).astype(np.float32)
    g_pad = jnp.zeros((3, n_pad), jnp.float32).at[:, :n].set(g.T)
    p_t = jfi.nsfp_params_to_t(jax.tree.map(jnp.asarray, params))
    zeros = [jnp.zeros_like(a) for a in p_t]
    newp, newm, newv = jfi._bwd_adam_call(
        jnp.zeros((1, 1)), jnp.zeros((1, 1)), jnp.zeros((1, 1)), xt_pad,
        g_pad, p_t, zeros, zeros, mlp_scale=0.0, lr=0.01, b1=0.9, b2=0.999,
        eps=1e-8, tn=128, interpret=True, model="nsfp")
    ref = {k: tfi.nsfp_params_to_flat(tpyr.params_from_numpy(
        jax.tree.map(np.asarray, jfi.nsfp_t_to_params(list(t)))))
        for k, t in (("p", newp), ("m", newm), ("v", newv))}

    flat = tfi.nsfp_params_to_flat(tpyr.params_from_numpy(params))
    partials = tfi.nsfp_bwd(flat, _t(pts), _t(g), TN)
    assert partials.shape == (1, flat.shape[0])
    p, m, v = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
    tfi.adam_step(p, m, v, partials, torch.tensor(0.0), torch.tensor(0.0),
                  0.01)
    for k, got in (("p", p), ("m", m), ("v", v)):
        err = (got - ref[k]).abs().max()
        assert err < 1e-5, (k, err)


def test_nsfp_bwd_plain_relu_subgradient_is_zero_at_zero():
    """A unit whose pre-activation is exactly 0 passes no gradient, as
    torch.relu's backward: the rule C11 follows (h > 0)."""
    ncfg = tbase.NSFPConfig(width=4, n_layers=3)
    params = [{"w": torch.zeros(3, 4), "b": torch.zeros(4)},
              {"w": torch.ones(4, 4), "b": torch.zeros(4)},
              {"w": torch.ones(4, 3), "b": torch.zeros(3)}]
    flat = tfi.nsfp_params_to_flat(params)
    x, g = torch.ones(5, 3), torch.ones(5, 3)
    grad = tfi.nsfp_flat_to_params(tfi.nsfp_bwd(flat, x, g, ncfg)[0], ncfg)
    assert not grad[0]["w"].any() and not grad[0]["b"].any()
    assert not grad[1]["w"].any() and not grad[1]["b"].any()
    assert torch.equal(grad[2]["b"], torch.full((3,), 5.0))


def test_run_fused_nsfp_matches_jax():
    pts, tgt, params = _setup()
    lk = dict(iters=5, lr=0.01, max_break_count=15,
              break_threshold_ratio=0.001)
    pv = np.ones(pts.shape[0], bool)
    tv = np.ones(tgt.shape[0], bool)
    jp, jst = jfi.run_fused_nsfp(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pts), jnp.asarray(pv),
        jnp.asarray(tgt), jnp.asarray(tv), JLoopConfig(**lk), interpret=True)
    tp, tst = tfi.run_fused_nsfp(
        tpyr.params_from_numpy(params), _t(pts), _t(pv), _t(tgt), _t(tv),
        LoopConfig(**lk), TN)
    assert int(tst["iters"]) == int(jst["iters"]) == 5
    assert abs(float(tst["loss"]) - float(jst["loss"])) < 1e-4
    for a, b in zip(tp, jp):
        for kk in ("w", "b"):
            assert np.abs(a[kk].numpy() - np.asarray(b[kk])).max() < 2e-2


def test_optimize_nsfp_fused_matches_unfused():
    """The port's two NSFP loops from the same weights: equal iteration
    count, loss within 1e-4, parameters within 2e-2 over 5 iterations
    (the horizon of the parity with JAX above)."""
    pts, tgt, params = _setup(seed=9)
    pv = torch.ones(pts.shape[0], dtype=torch.bool)
    tv = torch.ones(tgt.shape[0], dtype=torch.bool)
    outs = []
    for fused in (False, True):
        cfg = tsolve.NSFPSolverConfig(net=TN, iters=5, samples=180,
                                      use_fused_iteration=fused)
        outs.append(tsolve.optimize_nsfp(tpyr.params_from_numpy(params),
                                         _t(pts), pv, _t(tgt), tv, cfg))
    (p0, s0), (p1, s1) = outs
    assert int(s0["iters"]) == int(s1["iters"]) == 5
    assert abs(float(s0["loss"]) - float(s1["loss"])) < 1e-4
    for a, b in zip(p0, p1):
        for kk in ("w", "b"):
            assert (a[kk] - b[kk]).abs().max() < 2e-2
