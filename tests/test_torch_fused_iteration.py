"""Parity of the port's fused iteration (``ops/fused_iteration.py``) with
the JAX package's two-kernel iteration, on the CPU.

The port's kernel wrappers run their plain versions here (C2: the plain
warp, C1: the two-way argmin, C3: ``torch.func.vjp`` of the plain warp, C4:
the plain Adam, C5: the plain landmark iteration). The JAX kernels run in
Pallas interpret mode with the pins of tests/test_fused_iteration.py
(HIGHEST wide matmuls, the exact unpacked VPU-distance sweep). The kernel
pairs are checked for SE3 + axis_angle (``config/NDP.yaml``,
``config/LNDP.yaml``), Sim3 + euler (the shape-transfer demo) and the
yaml's further options: sflow, SE3 + quaternion, SE3 + 6D, Sim3 +
quaternion (level loops of those at the JAX tests' own horizons and
tolerances, tests/test_fused_iteration.py:289-297), and the nonrigidity
head (``w_reg > 0``) at levels 0 and 1: the warped points 1e-5 and the
nonrigidity 1e-6, one Adam step 1e-5.
Tolerances: warped points 1e-5, indices equal up to near-ties < 3e-4
relative, glue value 1e-6 and gradient 1e-5, one Adam step 1e-5 (with
``done`` bit-exact), a 25-iteration level loop equal iteration count, loss
1e-4, params and warped points 1e-3 (the bound of
tests/test_fused_iteration.py:280-286).
"""
import numpy as np
import pytest

import jax
import jax.flatten_util
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
# (motion, rotation_format) pairs that the kernels cover
MOTION_FORMATS = [("SE3", "axis_angle"), ("Sim3", "euler"),
                  ("sflow", "axis_angle"), ("SE3", "quaternion"),
                  ("SE3", "6D"), ("Sim3", "quaternion")]


def _cfgs(motion, fmt, nonrigid=False):
    kw = dict(KW, motion=motion, rotation_format=fmt,
              nonrigidity_est=nonrigid)
    return jpyr.NDPConfig(**kw), tpyr.NDPConfig(**kw)


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


def _setup(n=200, m=260, seed=0, jcfg=JCFG):
    """Points, target and one level's weights in the JAX layout (numpy)."""
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((n, 3)) * 0.4).astype(np.float32)
    tgt = (rng.standard_normal((m, 3)) * 0.4).astype(np.float32)
    shapes = jax.eval_shape(lambda k: jpyr.init_pyramid_params(k, jcfg),
                            jax.random.key(0))
    lvl = jax.tree.map(lambda a: (rng.uniform(-1, 1, a.shape[1:]) * 0.2)
                       .astype(np.float32), shapes)
    return pts, tgt, lvl


def _pad(pts, tgt, level=LEVEL):
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
    freq = jnp.exp2(jnp.float32(level) + 1.0 + JCFG.k0).reshape(1, 1)
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
    # the JAX package's gate: w_reg > 0 with the nonrigidity head
    nr = tpyr.NDPConfig(nonrigidity_est=True)
    for w_reg in (0.0, 0.5):
        assert tfi.supports_fused_iteration(nr, w_reg, 0)
        assert jfi.supports_fused_iteration(
            jpyr.NDPConfig(nonrigidity_est=True), w_reg, 0)
    assert not tfi.supports_fused_iteration(nr, 0.5, 5)
    for kw in (dict(motion="Sim3"), dict(rotation_format="euler"),
               dict(motion="Sim3", rotation_format="euler"),
               dict(motion="sflow"), dict(rotation_format="quaternion"),
               dict(rotation_format="6D"),
               dict(motion="Sim3", rotation_format="6D"),
               dict(motion="sflow", rotation_format="quaternion")):
        assert tfi.supports_fused_iteration(tpyr.NDPConfig(**kw), 0.0, 0)
    for kw in (dict(depth=1), dict(width=512), dict(width=256, depth=6)):
        assert not tfi.supports_fused_iteration(tpyr.NDPConfig(**kw), 0.0, 0)
    # C3 keeps every layer's activations in shared memory: 227 KB at most,
    # which the Sim3 scale head's extra slot exceeds at width 256, depth 5
    assert tfi.supports_fused_iteration(tpyr.NDPConfig(width=256, depth=5),
                                        0.0)
    assert not tfi.supports_fused_iteration(
        tpyr.NDPConfig(width=256, depth=5, motion="Sim3"), 0.0)
    assert tfi.level_param_count(tpyr.NDPConfig()) == 34694
    # the landmark paths: landmarks only, same warp coverage, w_reg == 0
    assert tfi.supports_fused_iteration_ldmk(TCFG, 0.0, 5)
    assert not tfi.supports_fused_iteration_ldmk(TCFG, 0.0, 0)
    assert not tfi.supports_fused_iteration_ldmk(TCFG, 0.5, 5)
    for kw in (dict(motion="sflow"), dict(rotation_format="quaternion"),
               dict(rotation_format="6D")):
        assert tfi.supports_fused_iteration_ldmk(tpyr.NDPConfig(**kw), 0.0, 5)
    assert not tfi.supports_fused_iteration_ldmk(
        tpyr.NDPConfig(nonrigidity_est=True), 0.0, 5)
    # head outputs a point: 3 (sflow) to 10 (Sim3 + 6D)
    assert tfi._head_slots(tpyr.NDPConfig(motion="sflow",
                                          rotation_format="6D")) == 3
    assert tfi._head_slots(tpyr.NDPConfig(motion="Sim3",
                                          rotation_format="6D")) == 10
    assert tfi._head_slots(tpyr.NDPConfig(motion="Sim3", rotation_format="6D",
                                          nonrigidity_est=True)) == 11
    assert tfi.level_param_count(nr) == 34694 + 129


@pytest.mark.parametrize("motion,fmt", MOTION_FORMATS)
def test_level_param_count_matches_ravel_pytree(motion, fmt):
    _param_count_matches(*_cfgs(motion, fmt))


@pytest.mark.parametrize("motion,fmt", [("SE3", "axis_angle"),
                                        ("Sim3", "6D")])
def test_level_param_count_with_nonrigidity_head(motion, fmt):
    """The flat layout gains the nr head in sorted-key order."""
    _param_count_matches(*_cfgs(motion, fmt, nonrigid=True))


def _param_count_matches(jcfg, tcfg):
    shapes = jax.eval_shape(lambda k: jpyr.init_pyramid_params(k, jcfg),
                            jax.random.key(0))
    one = jax.tree.map(lambda a: np.zeros(a.shape[1:], np.float32), shapes)
    flat, _ = jax.flatten_util.ravel_pytree(one)
    assert tfi.level_param_count(tcfg) == flat.shape[0]
    assert tpyr.ravel(tpyr.params_from_numpy(one)).shape == flat.shape


def test_c3_tile_fills_one_wave():
    """C3's tile (``bwd_tile``): whole 16-point m-tiles, as few a block as
    keep the grid within one wave of 132 SMs (2000 points: 125 blocks of
    16; 6000: 125 of 48), fewer where a block's shared memory would not
    fit (csrc/level_tile_tc.cuh c3_smem_floats: rows of 136 floats at width
    128)."""
    bench = tpyr.NDPConfig(m=9, k0=-8, depth=3, width=128)
    assert tfi.c3_smem(bench, 16) == 4 * 16 * (5 * 136 + 12 + 2 * 6)
    for n, tile in ((1, 16), (31, 16), (2000, 16), (2112, 16), (2113, 32),
                    (6000, 48)):
        assert tfi.bwd_tile(n, bench) == tile, n
        assert -(-n // tile) <= tfi.C3_MAX_BLOCKS
    wide = tpyr.NDPConfig(m=9, k0=-8, depth=5, width=256)
    tile = tfi.bwd_tile(100_000, wide)
    assert tile % 16 == 0 and tfi.c3_smem(wide, tile) <= tfi.SMEM_LIMIT
    assert tfi.c3_smem(wide, tile + 16) > tfi.SMEM_LIMIT


def test_c2_tile_fills_one_wave():
    """C2's tile (``fwd_tile``): C3's one-wave rule (2000 points: 125
    blocks of 16; 6000: 125 of 48) with C2's smaller shared memory (two
    activation buffers of rows of 136 floats at width 128), fewer points
    where a block would not fit."""
    bench = tpyr.NDPConfig(m=9, k0=-8, depth=3, width=128)
    assert tfi.c2_smem(bench, 16) == 4 * 16 * (2 * 136 + 9 + 6)
    for n in (1, 31, 2000, 2113, 6000):
        assert tfi.fwd_tile(n, bench) == tfi.bwd_tile(n, bench), n
    assert tfi.fwd_tile(100_000, bench) > tfi.bwd_tile(100_000, bench)
    wide = tpyr.NDPConfig(m=9, k0=-8, depth=5, width=256,
                          motion="Sim3", rotation_format="6D",
                          nonrigidity_est=True)
    tile = tfi.fwd_tile(1_000_000, wide)
    assert tile % 16 == 0 and tfi.c2_smem(wide, tile) <= tfi.SMEM_LIMIT
    assert tfi.c2_smem(wide, tile + 16) > tfi.SMEM_LIMIT


def test_kernel_argtypes_match_c_entry_points():
    """Each wrapper's ctypes argtypes name the C entry point's parameters
    in order, the stream last excluded (the binding appends it): a pointer
    as c_void_p, an int as c_int, a float as c_float. A mismatch would
    only show as a refused or corrupted call on the card."""
    import re
    from deformationpyramid_tpu_torch.match import attention
    from deformationpyramid_tpu_torch.ops import chamfer_fused, cuda_lib, knn

    src = "".join(p.read_text() for p in sorted(cuda_lib.CSRC.glob("*.cu")))
    kinds = {"void*": cuda_lib.P, "int": cuda_lib.I, "float": cuda_lib.F}
    for k in (knn.NN_DUAL, tfi.LEVEL_WARP_FWD, tfi.LEVEL_WARP_BWD,
              tfi.ADAM_STEP, tfi.LDMK_ITERATION, tfi.SCATTER_ROWS,
              tfi.NSFP_FWD, tfi.NSFP_BWD, attention.FLASH_ATTENTION, attention.FLASH_ATTENTION_BWD_DKV,
              attention.FLASH_ATTENTION_BWD_DQ, chamfer_fused.CHAMFER_FUSED,
              tfi.SUM_PARTIALS):
        decl = re.search(r'extern "C" int ' + k.symbol + r"\(([^)]*)\)", src)
        assert decl, k.symbol
        params = [re.fullmatch(r"\s*(?:const\s+)?(void\s*\*|int|float)\s*\w+\s*",
                               p).group(1).replace(" ", "")
                  for p in decl.group(1).split(",")]
        assert params[-1] == "void*", k.symbol            # the stream
        assert [kinds[p] for p in params[:-1]] == k.argtypes, k.symbol


@pytest.mark.parametrize("motion,fmt", MOTION_FORMATS)
def test_kernel1_pair_matches_fwd_sweep_call(motion, fmt):
    """C2 + C1 (plain) against JAX kernel 1: warped points and both
    directions' argmins."""
    jcfg, tcfg = _cfgs(motion, fmt)
    pts, tgt, lvl = _setup(jcfg=jcfg)
    xt_pad, xbig, yc, ysqb, freq, tm, _ = _pad(pts, tgt)
    warped_t, cmin, cidx, rmin, rarg = jfi._fwd_sweep_call(
        freq, xt_pad, xbig, yc, ysqb, jfi.params_to_t(lvl),
        mlp_scale=jcfg.mlp_scale, tm=tm, interpret=True, motion=motion,
        rotation_format=fmt)
    n, m = pts.shape[0], tgt.shape[0]

    flat = tpyr.ravel(tpyr.params_from_numpy(lvl))
    warped = tfi.level_warp_fwd(flat, _t(pts), LEVEL, tcfg)
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


@pytest.mark.parametrize("motion,fmt", MOTION_FORMATS)
def test_kernel2_pair_matches_bwd_adam_call(motion, fmt):
    """C3 + C4 (plain) against JAX kernel 2: one Adam step from zero
    moments within 1e-5; ``done`` holds params and moments bit-exactly."""
    jcfg, tcfg = _cfgs(motion, fmt)
    pts, tgt, lvl = _setup(seed=2, jcfg=jcfg)
    xt_pad, _, _, _, freq, _, n_pad = _pad(pts, tgt)
    n = pts.shape[0]
    g = (np.random.default_rng(3).standard_normal((n, 3)) * 0.1
         ).astype(np.float32)
    g_pad = jnp.zeros((3, n_pad), jnp.float32).at[:, :n].set(g.T)
    p_t = jfi.params_to_t(lvl)
    zeros = [jnp.zeros_like(a) for a in p_t]
    newp, newm, newv = jfi._bwd_adam_call(
        freq, jnp.zeros((1, 1)), jnp.zeros((1, 1)), xt_pad, g_pad, p_t,
        zeros, zeros, mlp_scale=jcfg.mlp_scale, lr=0.01, b1=0.9, b2=0.999,
        eps=1e-8, tn=128, interpret=True, motion=motion, rotation_format=fmt)
    ref = {k: tpyr.ravel(tpyr.params_from_numpy(
        jfi.t_to_params(list(t), motion=motion)))
        for k, t in (("p", newp), ("m", newm), ("v", newv))}

    flat = tpyr.ravel(tpyr.params_from_numpy(lvl))
    partials = tfi.level_warp_bwd(flat, _t(pts), _t(g), LEVEL, tcfg)
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


@pytest.mark.parametrize("level", [0, 1])
def test_kernel1_nonrigid_matches_fwd_sweep_call(level):
    """C2 with the nonrigidity head (plain) against JAX kernel 1 with
    ``nonrigid``: the warped points within 1e-5 and the nonrigidity within
    1e-6, gated at level 1, all ones at level 0."""
    jcfg, tcfg = _cfgs("SE3", "axis_angle", nonrigid=True)
    pts, tgt, lvl = _setup(seed=11, jcfg=jcfg)
    xt_pad, xbig, yc, ysqb, freq, tm, _ = _pad(pts, tgt, level)
    gate = jnp.full((1, 1), float(level > 0), jnp.float32)
    outs = jfi._fwd_sweep_call(
        freq, xt_pad, xbig, yc, ysqb, jfi.params_to_t(lvl),
        mlp_scale=jcfg.mlp_scale, tm=tm, interpret=True, nonrigid=True,
        gate=gate)
    n = pts.shape[0]
    flat = tpyr.ravel(tpyr.params_from_numpy(lvl))
    warped, nr = tfi.level_warp_fwd_nr(flat, _t(pts), level, tcfg)
    assert np.abs(warped.numpy() - np.asarray(outs[0]).T[:n]).max() < 1e-5
    assert np.abs(nr.numpy() - np.asarray(outs[5])[0, :n]).max() < 1e-6
    assert (level > 0) == bool((nr != 1.0).any())


@pytest.mark.parametrize("level", [0, 1])
def test_kernel2_nonrigid_matches_bwd_adam_call(level):
    """C3 with the nonrigidity cotangent + C4 (plain) against JAX kernel 2
    with ``nonrigid``: one Adam step from zero moments within 1e-5; at
    level 0 the nonrigidity head's moments stay exactly 0 (its gradient is
    exactly 0)."""
    jcfg, tcfg = _cfgs("SE3", "axis_angle", nonrigid=True)
    pts, tgt, lvl = _setup(seed=12, jcfg=jcfg)
    xt_pad, _, _, _, freq, _, n_pad = _pad(pts, tgt, level)
    n = pts.shape[0]
    rng = np.random.default_rng(13)
    g = (rng.standard_normal((n, 3)) * 0.1).astype(np.float32)
    g_nr = (rng.standard_normal(n) * 0.1).astype(np.float32)
    g_pad = jnp.zeros((3, n_pad), jnp.float32).at[:, :n].set(g.T)
    gnr_pad = jnp.zeros((1, n_pad), jnp.float32).at[0, :n].set(g_nr)
    p_t = jfi.params_to_t(lvl)
    zeros = [jnp.zeros_like(a) for a in p_t]
    newp, newm, newv = jfi._bwd_adam_call(
        freq, jnp.zeros((1, 1)), jnp.zeros((1, 1)), xt_pad, g_pad, p_t,
        zeros, zeros, mlp_scale=jcfg.mlp_scale, lr=0.01, b1=0.9, b2=0.999,
        eps=1e-8, tn=128, interpret=True, nonrigid=True,
        gate=jnp.full((1, 1), float(level > 0), jnp.float32), g_nr=gnr_pad)
    ref = {k: tpyr.ravel(tpyr.params_from_numpy(jfi.t_to_params(
        list(t), motion="SE3", nonrigid=True)))
        for k, t in (("p", newp), ("m", newm), ("v", newv))}
    flat = tpyr.ravel(tpyr.params_from_numpy(lvl))
    partials = tfi.level_warp_bwd(flat, _t(pts), _t(g), level, tcfg,
                                  _t(g_nr))
    p, m, v = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
    tfi.adam_step(p, m, v, partials, torch.tensor(0.0), torch.tensor(0.0),
                  0.01)
    for k, got in (("p", p), ("m", m), ("v", v)):
        assert (got - ref[k]).abs().max() < 1e-5, k
    nr_m = tpyr.unravel(m, tpyr.level_shapes(tcfg))["nr"]
    assert (level > 0) == bool(nr_m["w"].any() or nr_m["b"].any())


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


@pytest.mark.parametrize("motion,fmt,iters,tol", [
    # the quaternion and 6D formats renormalise a head output of ~mlp_scale,
    # so their backward is conditioned by 1 / |r| ~ 1e3 and float32
    # trajectories part after ~5 steps: the JAX tests' own short horizon
    ("sflow", "axis_angle", 25, 1e-3), ("SE3", "quaternion", 5, 1e-2),
    ("SE3", "6D", 5, 1e-2), ("Sim3", "quaternion", 5, 1e-2)])
def test_run_fused_level_variants_match_jax(motion, fmt, iters, tol):
    """A level loop for the further motions and formats: same iteration
    count, params and warped points within ``tol``, loss within ``tol`` /
    10 (1e-4 at the 25-iteration horizon; across two packages the
    renormalised formats' five steps agree on the loss to ~2e-4 of 0.35,
    in step with their parameters)."""
    jcfg, tcfg = _cfgs(motion, fmt)
    pts, tgt, _ = _setup(n=180, m=200, seed=8, jcfg=jcfg)
    # the JAX test's weights: the package's own init, level 1
    lvl = jax.tree.map(np.asarray, jpyr.level_params(
        jpyr.init_pyramid_params(jax.random.key(8), jcfg), LEVEL))
    lk = dict(iters=iters, lr=0.01, max_break_count=15,
              break_threshold_ratio=0.001)
    pv = np.ones(pts.shape[0], bool)
    tv = np.ones(tgt.shape[0], bool)
    jp, jw, jst = jfi.run_fused_level(
        jax.tree.map(jnp.asarray, lvl), jnp.asarray(pts), jnp.asarray(pv),
        jnp.asarray(tgt), jnp.asarray(tv), jnp.int32(LEVEL), jcfg,
        JLoopConfig(**lk), interpret=True)
    tp, tw, tst = tfi.run_fused_level(
        tpyr.params_from_numpy(lvl), _t(pts), _t(pv), _t(tgt), _t(tv),
        LEVEL, tcfg, LoopConfig(**lk))
    assert int(tst["iters"]) == int(jst["iters"])
    assert abs(float(tst["loss"]) - float(jst["loss"])) < tol / 10
    assert np.abs(tw.numpy() - np.asarray(jw)).max() < tol
    ref = tpyr.params_from_numpy(jax.tree.map(np.asarray, jp))
    for k in ref:
        for kk in ref[k]:
            assert (tp[k][kk] - ref[k][kk]).abs().max() < tol, (k, kk)


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


def test_scatter_rows_order_matches_index_add():
    """The y->x scatter of the glue: C6 adds each row's sources one after
    another in increasing index, as this loop does; that equals
    ``index_add_`` (its plain version) within 1e-7 on indices with many
    duplicates (bit for bit where index_add_ is sequential)."""
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 40, 3000)
    src = (rng.standard_normal((3000, 3)) * 1e-3).astype(np.float32)
    dst = (rng.standard_normal((50, 3)) * 1e-3).astype(np.float32)
    ref = tfi.scatter_add_rows(_t(dst), _t(idx), _t(src)).numpy()
    got = dst.copy()
    for j, i in enumerate(idx):
        got[i] = got[i] + src[j]
    assert np.abs(got - ref).max() < 1e-7
    assert np.array_equal(
        ref, torch.from_numpy(dst).index_add_(0, _t(idx), _t(src)).numpy())


@pytest.mark.parametrize("n,m,rows", [(30, 0, 30), (50, 3000, 4),
                                      (1, 500, 1), (400, 700, 1)])
def test_scatter_rows_plain_edge_cases(n, m, rows):
    """C6's plain version on the kernel's edge cases: no source at all,
    many repeats on a few rows, a single destination row, and every source
    on one row of many. Bit-equal to adding each row's sources in
    increasing index (C6's order), and within 1e-6 of its max of the JAX
    glue's ``.at[].add``, which XLA may sum in another order."""
    rng = np.random.default_rng(60 + m)
    idx = rng.integers(0, rows, m)
    src = rng.standard_normal((m, 3)).astype(np.float32)
    dst = rng.standard_normal((n, 3)).astype(np.float32)
    got = tfi.scatter_add_rows(_t(dst), _t(idx), _t(src)).numpy()
    ref = dst.copy()
    for j, i in enumerate(idx):
        ref[i] = ref[i] + src[j]
    assert np.array_equal(got, ref)
    jax_ref = np.asarray(jnp.asarray(dst).at[jnp.asarray(idx)].add(
        jnp.asarray(src)))
    assert np.abs(got - jax_ref).max() <= 1e-6 * np.abs(jax_ref).max()
    if m == 0:
        assert np.array_equal(got, dst)


def _ldmk_setup(jcfg, n=150, n_pad=256, seed=7):
    """Landmark rows, their targets and mask, and one level's weights."""
    pts, _, lvl = _setup(n=n, seed=seed, jcfg=jcfg)
    rng = np.random.default_rng(seed)
    tgt = (pts + rng.standard_normal(pts.shape) * 0.05).astype(np.float32)
    valid = rng.random(n) > 0.2
    return pts, tgt, valid, lvl


@pytest.mark.parametrize("motion,fmt", MOTION_FORMATS)
def test_ldmk_iteration_plain_matches_ldmk_iter_call(motion, fmt):
    """C5's plain version against JAX's ``_ldmk_iter_call``: one step
    (params, moments, warped rows within 1e-5, loss within 1e-6 relative,
    counter and done equal), then a step that the early stop holds (params
    and moments bit-exact, done set)."""
    jcfg, tcfg = _cfgs(motion, fmt)
    pts, tgt, valid, lvl = _ldmk_setup(jcfg)
    n, n_pad = pts.shape[0], 256
    xt_pad = jnp.zeros((3, n_pad), jnp.float32).at[:, :n].set(pts.T)
    tgt_pad = jnp.zeros((3, n_pad), jnp.float32).at[:, :n].set(tgt.T)
    mask = jnp.zeros((1, n_pad), jnp.float32).at[0, :n].set(valid)
    count = np.float32(max(valid.sum(), 1))
    freq = jnp.exp2(jnp.float32(LEVEL) + 1.0 + jcfg.k0).reshape(1, 1)
    p_t = jfi.params_to_t(lvl)
    zeros = [jnp.zeros_like(a) for a in p_t]
    flat = tpyr.ravel(tpyr.params_from_numpy(lvl))

    for loss_eps, loss_prev, counter in ((1e-4, 0.5, 3), (1e9, 1e6, 0)):
        lk = dict(iters=20, lr=0.01, max_break_count=15,
                  break_threshold_ratio=0.001, loss_eps=loss_eps)
        newp, newm, newv, warped_t, jloss, jcounter, jdone = \
            jfi._ldmk_iter_call(
                freq, jnp.full((1, 1), loss_prev, jnp.float32),
                jnp.full((1, 1), float(counter), jnp.float32),
                jnp.zeros((1, 1)), jnp.full((1, 1), count), xt_pad, tgt_pad,
                mask, p_t, zeros, zeros, mlp_scale=jcfg.mlp_scale, lr=0.01,
                b1=0.9, b2=0.999, eps=1e-8, interpret=True, motion=motion,
                rotation_format=fmt, max_break=15, thr_ratio=0.001,
                loss_eps=loss_eps)
        ref = {k: tpyr.ravel(tpyr.params_from_numpy(
            jfi.t_to_params(list(t), motion=motion)))
            for k, t in (("p", newp), ("m", newm), ("v", newv))}

        stop = tfi.EarlyStop(LoopConfig(**lk), torch.device("cpu"))
        stop.loss_prev = torch.tensor(loss_prev, dtype=torch.float32)
        stop.counter = torch.tensor(counter, dtype=torch.int32)
        p, m, v = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
        x = _t(pts)
        aux = x.clone()
        tfi.ldmk_iteration(p, m, v, x, _t(tgt), _t(valid.astype(np.float32)),
                           torch.tensor(count), stop, aux, LEVEL, tcfg, 0.01)
        assert bool(stop.done) == bool(jdone[0, 0] > 0.5)
        assert int(stop.counter) == int(jcounter[0, 0])
        assert int(stop.it) == 1
        assert abs(float(stop.loss) - float(jloss[0, 0])) \
            <= 1e-6 * abs(float(jloss[0, 0]))
        assert np.abs(aux.numpy() - np.asarray(warped_t).T[:n]).max() < 1e-5
        if loss_eps > 1.0:                      # held: nothing moves
            assert bool(stop.done) and int(stop.applied) == 0
            assert torch.equal(p, flat) and not m.any() and not v.any()
            assert torch.equal(ref["p"], flat)
        else:
            assert not bool(stop.done) and int(stop.applied) == 1
            for k, got in (("p", p), ("m", m), ("v", v)):
                assert (got - ref[k]).abs().max() < 1e-5, k


def test_ldmk_iteration_halted_changes_nothing():
    """An iteration that starts halted leaves params, moments, aux and the
    stop state as they were."""
    _, tcfg = _cfgs("SE3", "axis_angle")
    pts, tgt, valid, lvl = _ldmk_setup(JCFG, n=40)
    flat = tpyr.ravel(tpyr.params_from_numpy(lvl))
    stop = tfi.EarlyStop(LoopConfig(iters=5), torch.device("cpu"))
    stop.done = torch.tensor(True)
    p, m, v = flat.clone(), torch.ones_like(flat), torch.ones_like(flat)
    aux = torch.zeros(40, 3)
    tfi.ldmk_iteration(p, m, v, _t(pts), _t(tgt),
                       _t(valid.astype(np.float32)), torch.tensor(30.0),
                       stop, aux, LEVEL, tcfg, 0.01)
    assert torch.equal(p, flat) and (m == 1).all() and (v == 1).all()
    assert not aux.any() and int(stop.it) == 0 and int(stop.applied) == 0


def test_run_fused_level_ldmk_matches_jax():
    """The landmark-only level loop (C5 plain on the CPU) against JAX's
    ``run_fused_level_ldmk`` (its kernel in interpret mode): equal
    iteration count, loss within 1e-4, params and warped rows within
    1e-3."""
    pts, tgt, valid, lvl = _ldmk_setup(JCFG, n=120, seed=8)
    lk = dict(iters=25, lr=0.01, max_break_count=15,
              break_threshold_ratio=0.001)
    jp, jw, jst = jfi.run_fused_level_ldmk(
        jax.tree.map(jnp.asarray, lvl), jnp.asarray(pts), jnp.asarray(valid),
        jnp.asarray(tgt), jnp.int32(LEVEL), JCFG, JLoopConfig(**lk),
        interpret=True)
    tp, tw, tst = tfi.run_fused_level_ldmk(
        tpyr.params_from_numpy(lvl), _t(pts), _t(valid), _t(tgt), LEVEL,
        TCFG, LoopConfig(**lk))
    assert int(tst["iters"]) == int(jst["iters"])
    assert abs(float(tst["loss"]) - float(jst["loss"])) < 1e-4
    assert np.abs(tw.numpy() - np.asarray(jw)).max() < 1e-3
    ref = tpyr.params_from_numpy(jax.tree.map(np.asarray, jp))
    for k in ref:
        for kk in ref[k]:
            assert (tp[k][kk] - ref[k][kk]).abs().max() < 1e-3, (k, kk)


def test_run_fused_level_landmark_chamfer_matches_jax():
    """Landmark + chamfer mode (``n_ldmk > 0``, w_cd 1.0, trunc 0.25):
    pts = [ldmk ; sample], the landmark rows out of the chamfer. Against
    JAX's ``run_fused_level(n_ldmk=...)``: equal iteration count, loss
    within 1e-4, params and warped points within 1e-3."""
    n_ldmk = 40
    pts, tgt, lvl = _setup(n=160, m=200, seed=9)
    rng = np.random.default_rng(9)
    ltgt = (pts[:n_ldmk] + rng.standard_normal((n_ldmk, 3)) * 0.05
            ).astype(np.float32)
    lvalid = rng.random(n_ldmk) > 0.2
    pv = np.ones(pts.shape[0], bool)
    pv[:n_ldmk] = lvalid
    tv = np.ones(tgt.shape[0], bool)
    lk = dict(iters=25, lr=0.01, max_break_count=15,
              break_threshold_ratio=0.001)
    jp, jw, jst = jfi.run_fused_level(
        jax.tree.map(jnp.asarray, lvl), jnp.asarray(pts), jnp.asarray(pv),
        jnp.asarray(tgt), jnp.asarray(tv), jnp.int32(LEVEL), JCFG,
        JLoopConfig(**lk), trunc=0.25, n_ldmk=n_ldmk,
        tgt_ldmk=jnp.asarray(ltgt), ldmk_valid=jnp.asarray(lvalid),
        w_cd=1.0, interpret=True)
    tp, tw, tst = tfi.run_fused_level(
        tpyr.params_from_numpy(lvl), _t(pts), _t(pv), _t(tgt), _t(tv),
        LEVEL, TCFG, LoopConfig(**lk), trunc=0.25, n_ldmk=n_ldmk,
        tgt_ldmk=_t(ltgt), ldmk_valid=_t(lvalid), w_cd=1.0)
    assert int(tst["iters"]) == int(jst["iters"])
    assert abs(float(tst["loss"]) - float(jst["loss"])) < 1e-4
    assert np.abs(tw.numpy() - np.asarray(jw)).max() < 1e-3
    ref = tpyr.params_from_numpy(jax.tree.map(np.asarray, jp))
    for k in ref:
        for kk in ref[k]:
            assert (tp[k][kk] - ref[k][kk]).abs().max() < 1e-3, (k, kk)
