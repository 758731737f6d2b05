"""The layers of the port's landmark model against the JAX package's, on
the CPU: the same inputs, made from a seed with numpy, and the same weights
(drawn by the JAX init, converted with ``params_from_numpy``).

Tolerances (max abs, float32 on both sides; the differences are summation
order in the matrix products): position codes and rotary embedding 1e-6;
one attention layer 1e-5; the plain version of kernel C7 against the JAX
package's einsum attention on valid query rows 1e-5; KPConv rigid and
deformable (with its aux outputs) 1e-5; the KPFCN backbone 1e-4 (17 blocks
of instance-normalised features of order 1).
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deformationpyramid_tpu.data.synthetic import make_pair
from deformationpyramid_tpu.match import attention as jatt
from deformationpyramid_tpu.match import backbone as jbb
from deformationpyramid_tpu.match import kpconv as jkp
from deformationpyramid_tpu.match import position_encoding as jpe
import deformationpyramid_tpu_torch as tdp
from deformationpyramid_tpu_torch.data import collate as tcol
from deformationpyramid_tpu_torch.match import attention as tatt
from deformationpyramid_tpu_torch.match import backbone as tbb
from deformationpyramid_tpu_torch.match import kpconv as tkp
from deformationpyramid_tpu_torch.match import position_encoding as tpe


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _err(t, j):
    return float(np.abs(t.detach().numpy() - np.asarray(j)).max())


# ---------------- position encoding ----------------

@pytest.mark.parametrize("pe_type", ["rotary", "sinusoidal"])
@pytest.mark.parametrize("dim", [12, 96, 528])
def test_volumetric_pe_matches_jax(pe_type, dim):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(37, 3)).astype(np.float32)
    kw = dict(feature_dim=dim, voxel_size=0.04, vol_origin=(-0.6, -0.4, 0.2),
              pe_type=pe_type)
    j = jpe.volumetric_pe(jnp.asarray(xyz), jpe.VolPEConfig(**kw))
    t = tpe.volumetric_pe(_t(xyz), tpe.VolPEConfig(**kw))
    assert t.shape == j.shape and _err(t, j) < 1e-6


def test_embed_rotary_pairs_channels_as_jax():
    """The interleave alone: with cos = 0 and sin = 1 the output is the
    partner channel, (-x1, x0, -x3, x2, ...)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 12)).astype(np.float32)
    ang = rng.normal(size=(5, 12)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    j = jpe.embed_rotary(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    t = tpe.embed_rotary(_t(x), _t(cos), _t(sin))
    assert _err(t, j) < 1e-6
    partner = tpe.embed_rotary(_t(x), torch.zeros(5, 12), torch.ones(5, 12))
    want = np.stack([-x[:, 1::2], x[:, ::2]], -1).reshape(5, 12)
    assert np.array_equal(partner.numpy(), want)
    for pe_type in ("rotary", "sinusoidal"):
        cfg = dict(feature_dim=12, pe_type=pe_type, vol_origin=(0., 0., 0.))
        pts = rng.normal(size=(5, 3)).astype(np.float32) * 0.1
        jp = jpe.volumetric_pe(jnp.asarray(pts), jpe.VolPEConfig(**cfg))
        tp = tpe.volumetric_pe(_t(pts), tpe.VolPEConfig(**cfg))
        assert _err(tpe.embed_pos(pe_type, _t(x), tp),
                    jpe.embed_pos(pe_type, jnp.asarray(x), jp)) < 1e-6


# ---------------- attention ----------------

FD, HEADS = 96, 4


def _attention_inputs(seed, L, S, s_len, l_len, fd=FD, pe_type="rotary"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(L, fd)).astype(np.float32)
    src = rng.normal(size=(S, fd)).astype(np.float32)
    vol = dict(feature_dim=fd, vol_origin=(-1.0, -1.0, -1.0),
               pe_type=pe_type)
    xp = rng.uniform(-0.5, 0.5, (L, 3)).astype(np.float32)
    sp = rng.uniform(-0.5, 0.5, (S, 3)).astype(np.float32)
    x_pe = np.asarray(jpe.volumetric_pe(jnp.asarray(xp),
                                        jpe.VolPEConfig(**vol)))
    s_pe = np.asarray(jpe.volumetric_pe(jnp.asarray(sp),
                                        jpe.VolPEConfig(**vol)))
    return x, src, x_pe, s_pe, np.arange(L) < l_len, np.arange(S) < s_len


@pytest.mark.parametrize("case", ["masked", "no-mask", "compatibility",
                                  "sinusoidal", "no-pe"])
def test_attention_layer_xla_matches_jax(case):
    pe_type = {"sinusoidal": "sinusoidal", "no-pe": "none"}.get(case,
                                                                 "rotary")
    L, S = 40, 56
    x, src, x_pe, s_pe, xm, sm = _attention_inputs(
        2, L, S, 45, 33, pe_type="rotary" if pe_type == "none" else pe_type)
    jcfg = jatt.AttentionConfig(FD, HEADS, pe_type)
    tcfg = tatt.AttentionConfig(FD, HEADS, pe_type)
    jp = jatt.init_attention_layer(jax.random.key(3), jcfg)
    tp = tdp.params_from_numpy(_np_tree(jp))
    compat = None
    if case == "compatibility":
        compat = np.random.default_rng(4).uniform(0, 1, (L, S)).astype(
            np.float32)
    masks = (None, None) if case == "no-mask" else (xm, sm)
    pes = (None, None) if pe_type == "none" else (x_pe, s_pe)
    j = jatt.apply_attention_layer(
        jp, jnp.asarray(x), jnp.asarray(src),
        *(None if a is None else jnp.asarray(a) for a in pes),
        *(None if a is None else jnp.asarray(a) for a in masks), jcfg,
        compatibility=None if compat is None else jnp.asarray(compat))
    t = tatt.apply_attention_layer(
        tp, _t(x), _t(src), *(None if a is None else _t(a) for a in pes),
        *(None if a is None else _t(a) for a in masks), tcfg,
        compatibility=None if compat is None else _t(compat))
    assert _err(t, j) < 1e-5


def test_layer_norm_is_population_variance():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(7, 24)).astype(np.float32) * 3 + 1
    p = {"g": rng.normal(size=24).astype(np.float32),
         "b": rng.normal(size=24).astype(np.float32)}
    j = jatt._layer_norm(jnp.asarray(x), {k: jnp.asarray(v)
                                          for k, v in p.items()})
    t = tatt._layer_norm(_t(x), {k: _t(v) for k, v in p.items()})
    assert _err(t, j) < 1e-6


def _jax_xla_attention(q, k, v, src_mask, sm_scale):
    """softmax(q k^T * scale) v with padded source rows masked, as the JAX
    package's einsum path computes it on valid query rows."""
    a = jnp.einsum("lhd,shd->lsh", q, k)
    a = jnp.where((~src_mask)[None, :, None], -jnp.inf, a)
    a = jax.nn.softmax(a * sm_scale, axis=1)
    return jnp.einsum("lsh,shd->lhd", a, v)


@pytest.mark.parametrize("L,S,s_len,d", [(128, 128, 100, 24),
                                         (77, 133, 100, 132),
                                         (5, 3, 3, 7), (64, 65, 1, 33)])
def test_flash_attention_plain_matches_jax_einsum(L, S, s_len, d):
    rng = np.random.default_rng(6)
    q = rng.normal(size=(L, HEADS, d)).astype(np.float32)
    k = rng.normal(size=(S, HEADS, d)).astype(np.float32)
    v = rng.normal(size=(S, HEADS, d)).astype(np.float32)
    mask = np.arange(S) < s_len
    scale = 1.0 / math.sqrt(d)
    j = _jax_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(mask), scale)
    for src in (_t(mask), torch.tensor(s_len)):
        t = tatt.flash_attention_plain(_t(q), _t(k), _t(v), src, scale)
        assert _err(t, j) < 1e-5
    # the wrapper takes the plain version for CPU tensors
    w = tatt.flash_attention(_t(q), _t(k), _t(v), _t(mask), scale)
    assert torch.equal(w, tatt.flash_attention_plain(_t(q), _t(k), _t(v),
                                                     _t(mask), scale))
    if s_len == S or L == 5:
        full = tatt.flash_attention_plain(_t(q), _t(k[:s_len]),
                                          _t(v[:s_len]), None, scale)
        assert _err(full, j) < 1e-5


def test_flash_attention_plain_zero_length_and_padding_rows():
    """src_len == 0 gives zeros, not NaN; rows at or beyond src_len are
    never attended, whatever they hold."""
    rng = np.random.default_rng(7)
    q = _t(rng.normal(size=(9, 2, 12)).astype(np.float32))
    k = rng.normal(size=(11, 2, 12)).astype(np.float32)
    v = rng.normal(size=(11, 2, 12)).astype(np.float32)
    out = tatt.flash_attention_plain(q, _t(k), _t(v), torch.tensor(0), 0.3)
    assert out.shape == q.shape and not out.any()
    out = tatt.flash_attention_plain(q, _t(k[:0]), _t(v[:0]), None, 0.3)
    assert out.shape == q.shape and not out.any()
    k2, v2 = k.copy(), v.copy()
    k2[6:], v2[6:] = np.nan, np.inf
    a = tatt.flash_attention_plain(q, _t(k), _t(v), torch.tensor(6), 0.3)
    b = tatt.flash_attention_plain(q, _t(k2), _t(v2), torch.tensor(6), 0.3)
    assert torch.isfinite(b).all() and torch.equal(a, b)


def test_flash_route_matches_jax_layer_on_valid_rows():
    """``attention_impl='flash'`` on the CPU (C7's plain version inside the
    layer) against the JAX layer's einsum path: equal on valid query rows;
    padded query rows differ by design."""
    L, S = 48, 64
    x, src, x_pe, s_pe, xm, sm = _attention_inputs(8, L, S, 50, 40)
    jcfg = jatt.AttentionConfig(FD, HEADS, "rotary")
    jp = jatt.init_attention_layer(jax.random.key(9), jcfg)
    tp = tdp.params_from_numpy(_np_tree(jp))
    j = jatt.apply_attention_layer(jp, *(jnp.asarray(a) for a in
                                         (x, src, x_pe, s_pe, xm, sm)), jcfg)
    outs = {}
    for impl in ("flash", "xla"):
        tcfg = tatt.AttentionConfig(FD, HEADS, "rotary", attention_impl=impl)
        outs[impl] = tatt.apply_attention_layer(
            tp, *(_t(a) for a in (x, src, x_pe, s_pe, xm, sm)), tcfg)
        assert _err(outs[impl][xm], np.asarray(j)[xm]) < 1e-5
    assert _err(outs["xla"], j) < 1e-5
    assert (outs["flash"][~xm] - outs["xla"][~xm]).abs().max() > 1e-3


def test_flash_attention_backward_raises_and_config_checks():
    # the backward kernels' wrapper takes CUDA tensors only: on CPU tensors
    # it raises, and the wrapper differentiates its plain version instead
    q = torch.zeros(4, 2, 8, requires_grad=True)
    with pytest.raises(ValueError):
        tatt.flash_attention_bwd_cuda(q, q, q, q, torch.zeros(4, 2), q, None,
                                      1.0)
    out = tatt.flash_attention(q, q.detach(), q.detach(), None, 1.0)
    assert torch.autograd.grad(out.sum(), q)[0].shape == q.shape
    with pytest.raises(ValueError):
        tatt.AttentionConfig(attention_impl="pallas")
    # bfloat16 inference is ported (tests/test_torch_bf16_inference.py)
    assert tatt.AttentionConfig(compute_dtype="bfloat16").compute_dtype \
        == "bfloat16"
    with pytest.raises(ValueError):
        tatt.flash_attention_cuda(torch.zeros(4, 2, 8), torch.zeros(4, 2, 8),
                                  torch.zeros(4, 2, 8), None, 1.0)


# ---------------- KPConv ----------------

def _kp_inputs(seed, nq=60, ns=80, k=12, c=8):
    rng = np.random.default_rng(seed)
    s_pts = rng.uniform(-0.2, 0.2, (ns, 3)).astype(np.float32)
    q_pts = s_pts[:nq] + rng.normal(0, 0.01, (nq, 3)).astype(np.float32)
    d = ((q_pts[:, None] - s_pts[None]) ** 2).sum(-1)
    neighb = np.argsort(d, axis=1)[:, :k]
    far = np.take_along_axis(d, neighb, 1) > 0.12 ** 2
    neighb = np.where(far, ns, neighb).astype(np.int32)   # shadows
    x = rng.normal(size=(ns, c)).astype(np.float32)
    return q_pts, s_pts, neighb, x


@pytest.mark.parametrize("influence,aggregation",
                         [("linear", "sum"), ("gaussian", "sum"),
                          ("constant", "closest")])
def test_kpconv_rigid_matches_jax(influence, aggregation):
    q_pts, s_pts, neighb, x = _kp_inputs(10)
    kw = dict(num_kernel_points=15, KP_influence=influence,
              aggregation_mode=aggregation)
    jcfg, tcfg = jkp.KPConvConfig(**kw), tkp.KPConvConfig(**kw)
    jp = jkp.init_kpconv(jax.random.key(11), 8, 16, 0.125, jcfg)
    tp = tdp.params_from_numpy(_np_tree(jp))
    j = jkp.apply_kpconv(jp, jnp.asarray(q_pts), jnp.asarray(s_pts),
                         jnp.asarray(neighb), jnp.asarray(x), 0.1, jcfg)
    t = tkp.apply_kpconv(tp, _t(q_pts), _t(s_pts), _t(neighb), _t(x), 0.1,
                         tcfg)
    assert t.shape == (60, 16) and _err(t, j) < 1e-5
    assert float(t.abs().max()) > 1e-3


@pytest.mark.parametrize("modulated", [False, True])
def test_kpconv_deformable_with_aux_matches_jax(modulated):
    q_pts, s_pts, neighb, x = _kp_inputs(12)
    jcfg = jkp.KPConvConfig(modulated=modulated)
    tcfg = tkp.KPConvConfig(modulated=modulated)
    jp = jkp.init_kpconv(jax.random.key(13), 8, 16, 0.125, jcfg,
                         deformable=True)
    jp["offset_bias"] = jp["offset_bias"] + 0.05   # off the zero init
    tp = tdp.params_from_numpy(_np_tree(jp))
    j, jaux = jkp.apply_kpconv(jp, jnp.asarray(q_pts), jnp.asarray(s_pts),
                               jnp.asarray(neighb), jnp.asarray(x), 0.1,
                               jcfg, deformable=True, with_aux=True)
    t, taux = tkp.apply_kpconv(tp, _t(q_pts), _t(s_pts), _t(neighb), _t(x),
                               0.1, tcfg, deformable=True, with_aux=True)
    assert _err(t, j) < 1e-5
    assert _err(taux["deformed_kp"], jaux["deformed_kp"]) < 1e-5
    finite = np.asarray(jaux["min_d2"]) < 1e6
    assert _err(taux["min_d2"][_t(finite)],
                np.asarray(jaux["min_d2"])[finite]) < 1e-5


def test_init_kpconv_tree_and_kernel_points():
    cfg = tkp.KPConvConfig()
    p = tkp.init_kpconv(torch.Generator().manual_seed(0), 8, 16, 0.125, cfg,
                        deformable=True)
    jp = jkp.init_kpconv(jax.random.key(0), 8, 16, 0.125, jkp.KPConvConfig(),
                         deformable=True)
    assert jax.tree.structure(_np_tree(jp)) == jax.tree.structure(
        jax.tree.map(lambda a: a.numpy(), p))
    assert np.array_equal(p["kernel_points"].numpy(),
                          np.asarray(jp["kernel_points"]))
    for a, b in zip(jax.tree.leaves(_np_tree(jp)),
                    jax.tree.leaves(jax.tree.map(lambda a: a.numpy(), p))):
        assert a.shape == b.shape
    bound = 1.0 / math.sqrt(8 * 15)
    assert float(p["weights"].abs().max()) <= bound
    assert float(p["weights"].abs().max()) > 0.9 * bound


@pytest.mark.parametrize("masked", [False, True])
def test_instance_norm_and_pools_match_jax(masked):
    rng = np.random.default_rng(14)
    x = (rng.normal(size=(50, 6)) * 2 + 1).astype(np.float32)
    valid = np.arange(50) < 41 if masked else None
    j = jkp.instance_norm(jnp.asarray(x),
                          None if valid is None else jnp.asarray(valid), True)
    t = tkp.instance_norm(_t(x), None if valid is None else _t(valid), True)
    assert _err(t, j) < 1e-5
    bias = rng.normal(size=6).astype(np.float32)
    assert _err(tkp.instance_norm(_t(x), None, False, _t(bias)),
                jkp.instance_norm(jnp.asarray(x), None, False,
                                  jnp.asarray(bias))) < 1e-6
    inds = rng.integers(0, 51, (20, 5)).astype(np.int32)
    for tf, jf in ((tkp.max_pool, jkp.max_pool),
                   (tkp.closest_pool, jkp.closest_pool)):
        assert _err(tf(_t(x), _t(inds)), jf(jnp.asarray(x),
                                            jnp.asarray(inds))) == 0.0
    assert _err(tkp.leaky_relu(_t(x)), jkp.leaky_relu(jnp.asarray(x))) < 1e-7


# ---------------- KPFCN backbone ----------------

SMALL = dict(first_subsampling_dl=0.05, first_feats_dim=32,
             coarse_feature_dim=96, fine_feature_dim=24)


def _pyramids(cfg, n=400, seed=0):
    src, tgt, _ = make_pair(n=n, seed=seed, deform=0.05)
    limits = tcol.calibrate_neighborhood_limits([(src, tgt)], cfg,
                                                tbb.KPFCN_ARCHITECTURE)
    pyr = tcol.build_pair_pyramid(src, tgt, cfg, tbb.KPFCN_ARCHITECTURE,
                                  limits, pad_to="pow2")
    tp = tcol.pyramid_to_device(pyr, "cpu")
    jp = {k: ([jnp.asarray(a) for a in getattr(pyr, k)]
              if k != "features" else jnp.asarray(pyr.features))
          for k in ("points", "valids", "neighbors", "pools", "upsamples",
                    "features")}
    return pyr, tp, jp


@pytest.mark.parametrize("use_bn", [True, False])
def test_kpfcn_coarse_matches_jax(use_bn):
    kw = dict(SMALL, use_batch_norm=use_bn)
    jcfg, tcfg = jkp.KPConvConfig(**kw), tkp.KPConvConfig(**kw)
    pyr, tpyr, jpyr = _pyramids(tcfg)
    jp = jbb.init_kpfcn(jax.random.key(15), jcfg)
    tp = tdp.params_from_numpy(_np_tree(jp))
    j = jax.jit(lambda p, y: jbb.apply_kpfcn_coarse(p, y, jcfg))(jp, jpyr)
    t = tbb.apply_kpfcn_coarse(tp, tpyr, tcfg)
    assert t.shape == (len(pyr.points[2]), 96)
    valid = pyr.valids[2]
    scale = float(np.abs(np.asarray(j)[valid]).max())
    err = _err(t[_t(valid)], np.asarray(j)[valid])
    # without the normalisation the features shrink to ~3e-3: hold the
    # error to the same share of their scale
    assert err < 1e-4 * min(max(scale, 1e-3), 1.0), (err, scale)
    assert scale > 1e-3


def test_init_kpfcn_tree_matches_jax_structure():
    cfg = tkp.KPConvConfig(**SMALL)
    tp = tbb.init_kpfcn(torch.Generator().manual_seed(0), cfg)
    jp = jbb.init_kpfcn(jax.random.key(0), jkp.KPConvConfig(**SMALL))
    tn = jax.tree.map(lambda a: a.numpy(), tp)
    assert jax.tree.structure(tn) == jax.tree.structure(_np_tree(jp))
    for a, b in zip(jax.tree.leaves(tn), jax.tree.leaves(_np_tree(jp))):
        assert a.shape == b.shape and a.dtype == b.dtype
    back = tdp.params_to_numpy(tdp.params_from_numpy(_np_tree(jp)))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_np_tree(jp))):
        assert np.array_equal(a, b)
