"""Parity of the port's fused iteration (``ops/fused_iteration.py``) with
the JAX package's two-kernel iteration, on the CPU.

The port's kernel wrappers run their plain versions here (C2: the plain
warp, C1: the two-way argmin, C3: ``torch.func.vjp`` of the plain warp, C4:
the plain Adam). The JAX kernels run in Pallas interpret mode with the pins
of tests/test_fused_iteration.py (HIGHEST wide matmuls, the exact unpacked
VPU-distance sweep). Tolerances: warped points 1e-5, indices equal up to
near-ties < 3e-4 relative, glue value 1e-6 and gradient 1e-5, one Adam step
1e-5 (with ``done`` bit-exact), a 25-iteration level loop equal iteration
count, loss 1e-4, params and warped points 1e-3 (the bound of
tests/test_fused_iteration.py:280-286).
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
JCFG = jpyr.NDPConfig(**KW)
TCFG = tpyr.NDPConfig(**KW)
LEVEL = 1


@pytest.fixture(autouse=True)
def _exact_jax_kernels():
    """The pins of tests/test_fused_iteration.py: exact wide matmuls and
    the unpacked, VPU-distance (v1) selection."""
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


def _setup(n=200, m=260, seed=0):
    """Points, target and one level's weights in the JAX layout (numpy)."""
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((n, 3)) * 0.4).astype(np.float32)
    tgt = (rng.standard_normal((m, 3)) * 0.4).astype(np.float32)
    shapes = jax.eval_shape(lambda k: jpyr.init_pyramid_params(k, JCFG),
                            jax.random.key(0))
    lvl = jax.tree.map(lambda a: (rng.uniform(-1, 1, a.shape[1:]) * 0.2)
                       .astype(np.float32), shapes)
    return pts, tgt, lvl


def _pad(pts, tgt):
    """The padding prologue of JAX's run_fused_level, for the kernel calls."""
    n, m = pts.shape[0], tgt.shape[0]
    n_pad = jfi._round_up(max(n, 128), 128)
    tm = min(512, jfi._round_up(max(m, 8), 8))
    m_pad = jfi._round_up(max(m, tm), tm)
    xt_pad = jnp.zeros((3, n_pad), jnp.float32).at[:, :n].set(pts.T)
    xbig = jnp.where(jnp.arange(n_pad) < n, 0.0, jfi._BIG)[None, :]
    yc = jnp.zeros((m_pad, 3), jnp.float32).at[:m].set(tgt)
    yv = jnp.arange(m_pad) < m
    ysqb = jnp.where(yv, jnp.sum(yc * yc, axis=-1), jfi._BIG)[:, None]
    freq = jnp.exp2(jnp.float32(LEVEL) + 1.0 + JCFG.k0).reshape(1, 1)
    return xt_pad, xbig, yc, ysqb, freq, tm, n_pad


def near_tie_ok(idx, ref_idx, q, db):
    flips = idx != ref_idx
    if not flips.any():
        return
    d_got = ((q[flips] - db[idx[flips]]) ** 2).sum(-1)
    d_ref = ((q[flips] - db[ref_idx[flips]]) ** 2).sum(-1)
    assert (np.abs(d_got - d_ref) / np.maximum(d_ref, 1e-30)).max() < 3e-4


def test_supports_gate():
    assert tfi.supports_fused_iteration(TCFG, 0.0, 0)
    assert not tfi.supports_fused_iteration(TCFG, 0.5, 0)
    assert not tfi.supports_fused_iteration(TCFG, 0.0, 5)
    for kw in (dict(motion="Sim3"), dict(motion="sflow"),
               dict(rotation_format="euler"), dict(nonrigidity_est=True),
               dict(depth=1), dict(width=512), dict(width=256, depth=6)):
        assert not tfi.supports_fused_iteration(tpyr.NDPConfig(**kw), 0.0, 0)
    # C3 keeps every layer's activations in shared memory: 227 KB at most
    assert tfi.supports_fused_iteration(tpyr.NDPConfig(width=256, depth=5),
                                        0.0)
    assert tfi.level_param_count(tpyr.NDPConfig()) == 34694


def test_kernel_argtypes_match_c_entry_points():
    """Each wrapper's ctypes argtypes name the C entry point's parameters
    in order, the stream last excluded (the binding appends it): a pointer
    as c_void_p, an int as c_int, a float as c_float. A mismatch would
    only show as a refused or corrupted call on the card."""
    import re
    from deformationpyramid_tpu_torch.ops import cuda_lib, knn

    src = "".join(p.read_text() for p in sorted(cuda_lib.CSRC.glob("*.cu")))
    kinds = {"void*": cuda_lib.P, "int": cuda_lib.I, "float": cuda_lib.F}
    for k in (knn.NN_DUAL, tfi.LEVEL_WARP_FWD, tfi.LEVEL_WARP_BWD,
              tfi.ADAM_STEP):
        decl = re.search(r'extern "C" int ' + k.symbol + r"\(([^)]*)\)", src)
        assert decl, k.symbol
        params = [re.fullmatch(r"\s*(?:const\s+)?(void\s*\*|int|float)\s*\w+\s*",
                               p).group(1).replace(" ", "")
                  for p in decl.group(1).split(",")]
        assert params[-1] == "void*", k.symbol            # the stream
        assert [kinds[p] for p in params[:-1]] == k.argtypes, k.symbol


def test_kernel1_pair_matches_fwd_sweep_call():
    """C2 + C1 (plain) against JAX kernel 1: warped points and both
    directions' argmins."""
    pts, tgt, lvl = _setup()
    xt_pad, xbig, yc, ysqb, freq, tm, _ = _pad(pts, tgt)
    warped_t, cmin, cidx, rmin, rarg = jfi._fwd_sweep_call(
        freq, xt_pad, xbig, yc, ysqb, jfi.params_to_t(lvl),
        mlp_scale=JCFG.mlp_scale, tm=tm, interpret=True)
    n, m = pts.shape[0], tgt.shape[0]

    flat = tpyr.ravel(tpyr.params_from_numpy(lvl))
    warped = tfi.level_warp_fwd(flat, _t(pts), LEVEL, TCFG)
    sq_x, idx_x, sq_y, idx_y = tfi.nn_argmin_dual(warped, _t(tgt))
    w = warped.numpy()
    assert np.abs(w - np.asarray(warped_t).T[:n]).max() < 1e-5
    near_tie_ok(idx_x.numpy(), np.asarray(cidx)[0, :n], w, tgt)
    near_tie_ok(idx_y.numpy(), np.asarray(rarg)[:m, 0], tgt, w)
    assert np.abs(sq_x.numpy() - np.asarray(cmin)[0, :n]).max() < 1e-5
    assert np.abs(sq_y.numpy() - np.asarray(rmin)[:m, 0]).max() < 1e-5


@pytest.mark.parametrize("trunc", [1e9, 0.25])
def test_chamfer_glue_matches_jax(trunc):
    pts, tgt, lvl = _setup(seed=1)
    n, m = pts.shape[0], tgt.shape[0]
    rng = np.random.default_rng(1)
    xv = rng.random(n) > 0.1
    yv = rng.random(m) > 0.1
    w = pts + (rng.standard_normal(pts.shape) * 0.01).astype(np.float32)
    _, cidx, _, rarg = tfi.nn_argmin_dual(_t(w), _t(tgt), _t(xv), _t(yv))
    x_len, y_len = np.float32(xv.sum()), np.float32(yv.sum())
    loss, g = tfi._chamfer_glue(_t(w), cidx, rarg, _t(tgt), _t(xv), _t(yv),
                                _t(x_len), _t(y_len), trunc)
    rloss, rg = jax.jit(jfi._chamfer_glue, static_argnums=8)(
        jnp.asarray(w.T), jnp.asarray(cidx.numpy()[None].astype(np.int32)),
        jnp.asarray(rarg.numpy()[:, None].astype(np.int32)), jnp.asarray(tgt),
        jnp.asarray(xv), jnp.asarray(yv), jnp.float32(x_len),
        jnp.float32(y_len), trunc)
    assert abs(float(loss) - float(rloss)) < 1e-6
    assert np.abs(g.numpy() - np.asarray(rg).T).max() < 1e-5


def test_kernel2_pair_matches_bwd_adam_call():
    """C3 + C4 (plain) against JAX kernel 2: one Adam step from zero
    moments within 1e-5; ``done`` holds params and moments bit-exactly."""
    pts, tgt, lvl = _setup(seed=2)
    xt_pad, _, _, _, freq, _, n_pad = _pad(pts, tgt)
    n = pts.shape[0]
    g = (np.random.default_rng(3).standard_normal((n, 3)) * 0.1
         ).astype(np.float32)
    g_pad = jnp.zeros((3, n_pad), jnp.float32).at[:, :n].set(g.T)
    p_t = jfi.params_to_t(lvl)
    zeros = [jnp.zeros_like(a) for a in p_t]
    newp, newm, newv = jfi._bwd_adam_call(
        freq, jnp.zeros((1, 1)), jnp.zeros((1, 1)), xt_pad, g_pad, p_t,
        zeros, zeros, mlp_scale=JCFG.mlp_scale, lr=0.01, b1=0.9, b2=0.999,
        eps=1e-8, tn=128, interpret=True)
    ref = {k: tpyr.ravel(tpyr.params_from_numpy(jfi.t_to_params(list(t))))
           for k, t in (("p", newp), ("m", newm), ("v", newv))}

    flat = tpyr.ravel(tpyr.params_from_numpy(lvl))
    partials = tfi.level_warp_bwd(flat, _t(pts), _t(g), LEVEL, TCFG)
    assert partials.shape == (1, flat.shape[0])
    p, m, v = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
    tfi.adam_step(p, m, v, partials, torch.tensor(0.0), torch.tensor(0.0),
                  0.01)
    for k, got in (("p", p), ("m", m), ("v", v)):
        err = (got - ref[k]).abs().max()
        assert err < 1e-5, (k, err)

    held = flat.clone()
    m0, v0 = torch.zeros_like(flat), torch.zeros_like(flat)
    tfi.adam_step(held, m0, v0, partials, torch.tensor(3.0),
                  torch.tensor(1.0), 0.01)
    assert torch.equal(held, flat)
    assert not m0.any() and not v0.any()


def test_adam_step_bias_correction_by_applied_steps():
    """Later steps: the bias correction counts applied steps; the plain
    Adam equals optax.adam run for the same number of steps."""
    import optax

    rng = np.random.default_rng(4)
    p0 = rng.standard_normal(50).astype(np.float32)
    grads = rng.standard_normal((4, 50)).astype(np.float32)
    opt = optax.adam(0.01)
    jp, st = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    p, m, v = _t(p0), torch.zeros(50), torch.zeros(50)
    for i, gr in enumerate(grads):
        upd, st = opt.update(jnp.asarray(gr), st, jp)
        jp = optax.apply_updates(jp, upd)
        tfi.adam_step(p, m, v, _t(gr)[None], torch.tensor(float(i)),
                      torch.tensor(0.0), 0.01)
    assert np.abs(p.numpy() - np.asarray(jp)).max() < 1e-6


def test_run_fused_level_matches_jax():
    """A whole level, 25 iterations: same iteration count, loss within
    1e-4, params and warped points within 1e-3."""
    pts, tgt, lvl = _setup(n=180, m=200, seed=5)
    lk = dict(iters=25, lr=0.01, max_break_count=15,
              break_threshold_ratio=0.001)
    pv = np.ones(pts.shape[0], bool)
    tv = np.ones(tgt.shape[0], bool)
    jp, jw, jst = jfi.run_fused_level(
        jax.tree.map(jnp.asarray, lvl), jnp.asarray(pts), jnp.asarray(pv),
        jnp.asarray(tgt), jnp.asarray(tv), jnp.int32(LEVEL), JCFG,
        JLoopConfig(**lk), interpret=True)
    tp, tw, tst = tfi.run_fused_level(
        tpyr.params_from_numpy(lvl), _t(pts), _t(pv), _t(tgt), _t(tv),
        LEVEL, TCFG, LoopConfig(**lk))
    assert int(tst["iters"]) == int(jst["iters"])
    assert abs(float(tst["loss"]) - float(jst["loss"])) < 1e-4
    assert np.abs(tw.numpy() - np.asarray(jw)).max() < 1e-3
    ref = tpyr.params_from_numpy(jax.tree.map(np.asarray, jp))
    for k in ref:
        for kk in ref[k]:
            assert (tp[k][kk] - ref[k][kk]).abs().max() < 1e-3, (k, kk)


def test_early_stop_halts_with_host_reads_every_few_iterations():
    """A loss that plateaus at once stops after max_break_count counted
    iterations even though the host reads the flag every SYNC_EVERY
    iterations: the halted iterations in between change nothing."""
    cfg = LoopConfig(iters=100, max_break_count=3)
    stop = tfi.EarlyStop(cfg, torch.device("cpu"))
    calls = []

    def step():
        loss = torch.tensor(1e6)         # |loss_prev - loss| = 0: plateau
        halt, hold = stop.decide(loss)
        calls.append(bool(hold))
        stop.advance(loss, halt, hold)

    stop.run(step)
    assert len(calls) == tfi.SYNC_EVERY
    assert int(stop.it) == 3 and int(stop.applied) == 2
    assert calls[:3] == [False, False, True] and all(calls[3:])
