"""The streamed attention's backward on the CPU: ``flash_attention_bwd_plain``
(the plain version of kernels C8 and C9, written from the formulas) against

* autograd through ``flash_attention_plain`` (the plain version of C7): 1e-5
  max abs on unit-scale inputs in float32, 1e-12 in float64;
* ``jax.vjp`` of the JAX package's einsum attention, on valid query rows
  (the two routes differ on padded query rows only): 1e-5;
* ``jax.vjp`` of the stock TPU flash-attention module's plain reference
  ``mha_reference`` with segment ids, which is the function the stock Pallas
  kernels and their two backward kernels compute (pure jnp, runs on the CPU;
  the kernels themselves do not): 1e-5;

including an empty source prefix and NaN in the padded source rows; and one
whole attention layer with ``attention_impl='flash'`` (on CPU tensors the
plain versions) against the JAX layer on its einsum route, gradients w.r.t.
inputs and every weight: 1e-4 of each leaf's max.
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as stock

from deformationpyramid_tpu.match import attention as jatt
import deformationpyramid_tpu_torch as tdp
from deformationpyramid_tpu_torch.match import attention as tatt

from tests.test_torch_match_layers import (_attention_inputs,
                                           _jax_xla_attention)

HEADS = 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, L, S, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(n, HEADS, d)).astype(dtype)
                 for n in (L, S, S, L))


def _plain_bwd(q, k, v, do, src, scale):
    o, lse = tatt.flash_attention_plain(_t(q), _t(k), _t(v), src, scale,
                                        return_lse=True)
    return o, lse, tatt.flash_attention_bwd_plain(
        _t(q), _t(k), _t(v), o, lse, _t(do), src, scale)


@pytest.mark.parametrize("L,S,s_len,d", [(128, 128, 100, 24),
                                         (77, 133, 100, 132),
                                         (5, 3, 3, 7), (64, 65, 1, 33),
                                         (9, 11, 0, 12)])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)])
def test_bwd_plain_matches_autograd_of_the_plain_forward(L, S, s_len, d,
                                                         dtype, tol):
    q, k, v, do = _inputs(0, L, S, d, dtype)
    scale = 1.0 / math.sqrt(d)
    for src in (torch.tensor(s_len), _t(np.arange(S) < s_len)):
        leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
        o = tatt.flash_attention(*leaves, src, scale)   # CPU: the plain one
        auto = torch.autograd.grad(o, leaves, _t(do))
        _, lse, got = _plain_bwd(q, k, v, do, src, scale)
        for name, a, b in zip(("dq", "dk", "dv"), got, auto):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert float((a - b).abs().max()) <= tol, name
        assert not got[1][s_len:].any() and not got[2][s_len:].any()
        if s_len == 0:
            assert not got[0].any() and torch.isinf(lse).all()


def test_bwd_plain_without_a_mask_and_with_no_rows():
    q, k, v, do = _inputs(1, 6, 8, 10)
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    auto = torch.autograd.grad(
        tatt.flash_attention_plain(*leaves, None, 0.3), leaves, _t(do))
    _, _, got = _plain_bwd(q, k, v, do, None, 0.3)
    assert all(float((a - b).abs().max()) <= 1e-5 for a, b in zip(got, auto))
    _, _, empty = _plain_bwd(q, k[:0], v[:0], do, None, 0.3)
    assert not empty[0].any() and empty[1].shape == (0, HEADS, 10)
    _, _, none = _plain_bwd(q[:0], k, v, do[:0], None, 0.3)
    assert none[0].shape == (0, HEADS, 10) and not none[1].any()


def test_nan_in_padded_source_rows_reaches_no_gradient():
    q, k, v, do = _inputs(2, 9, 11, 12)
    k2, v2 = k.copy(), v.copy()
    k2[6:], v2[6:] = np.nan, np.inf
    src = torch.tensor(6)
    _, _, clean = _plain_bwd(q, k, v, do, src, 0.3)
    _, _, dirty = _plain_bwd(q, k2, v2, do, src, 0.3)
    for a, b in zip(clean, dirty):
        assert torch.isfinite(b).all() and torch.equal(a, b)
    # and through autograd of the plain forward, the CPU training route
    leaves = [_t(a).requires_grad_(True) for a in (q, k2, v2)]
    auto = torch.autograd.grad(
        tatt.flash_attention(*leaves, src, 0.3), leaves, _t(do))
    for a, b in zip(auto, clean):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-5


@pytest.mark.parametrize("L,S,s_len,d", [(128, 128, 100, 24),
                                         (77, 133, 100, 132),
                                         (64, 65, 1, 33)])
def test_bwd_plain_matches_jax_vjp_of_the_einsum_attention(L, S, s_len, d):
    """Every query row here is valid, which is where the JAX package's
    einsum route and the streamed route compute the same function."""
    q, k, v, do = _inputs(3, L, S, d)
    scale = 1.0 / math.sqrt(d)
    mask = np.arange(S) < s_len
    _, vjp = jax.vjp(lambda a, b, c: _jax_xla_attention(
        a, b, c, jnp.asarray(mask), scale), *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(do))
    _, _, got = _plain_bwd(q, k, v, do, _t(mask), scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-5, name


@pytest.mark.parametrize("L,S,s_len,d", [(128, 128, 100, 24),
                                         (128, 256, 131, 132)])
def test_bwd_plain_matches_the_stock_reference_with_segment_ids(L, S, s_len,
                                                                d):
    """``mha_reference`` is what the stock TPU kernels (forward, dK/dV, dQ)
    are tested against upstream; the JAX package calls them with query
    segment id 1 and source ids 1 on the valid prefix, 0 beyond."""
    q, k, v, do = _inputs(4, L, S, d)
    scale = 1.0 / math.sqrt(d)
    seg = stock.SegmentIds(
        q=jnp.ones((1, L), jnp.int32),
        kv=jnp.asarray((np.arange(S) < s_len).astype(np.int32))[None])
    to4 = lambda a: jnp.asarray(a).transpose(1, 0, 2)[None]    # noqa: E731
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(
            # the reference's own backward takes sm_scale 1 only: scale q
            lambda a, b, c: stock._mha_reference(
                a * scale, b, c, None, seg, causal=False,
                mask_value=stock.DEFAULT_MASK_VALUE, sm_scale=1.0,
                save_residuals=False), to4(q), to4(k), to4(v))
        ref = vjp(to4(do))
    o, _, got = _plain_bwd(q, k, v, do, torch.tensor(s_len), scale)
    back = lambda a: np.asarray(a)[0].transpose(1, 0, 2)       # noqa: E731
    assert np.abs(o.numpy() - back(out)).max() <= 1e-5
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert np.abs(a.numpy() - back(b)).max() <= 1e-5, name


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_attention_layer_flash_route_gradients_match_jax():
    """One layer, flash route in the port (plain versions on the CPU)
    against the JAX layer's einsum route; the cotangent is zero on padded
    query rows, as every consumer's mask makes it."""
    fd, L, S, l_len, s_len = 96, 40, 56, 33, 45
    x, src, x_pe, s_pe, xm, sm = _attention_inputs(2, L, S, s_len, l_len,
                                                   fd=fd)
    ct = np.random.default_rng(5).normal(size=(L, fd)).astype(np.float32)
    ct[l_len:] = 0.0
    jcfg = jatt.AttentionConfig(fd, HEADS, "rotary")
    tcfg = tatt.AttentionConfig(fd, HEADS, "rotary", attention_impl="flash")
    jp = jatt.init_attention_layer(jax.random.key(3), jcfg)

    def jf(p, x_, s_):
        return jatt.apply_attention_layer(
            p, x_, s_, jnp.asarray(x_pe), jnp.asarray(s_pe),
            jnp.asarray(xm), jnp.asarray(sm), jcfg)

    jout, vjp = jax.vjp(jf, jp, jnp.asarray(x), jnp.asarray(src))
    jg = _np_tree(vjp(jnp.asarray(ct)))

    tp = tdp.params_from_numpy(_np_tree(jp))
    tp = jax.tree.map(lambda t: t.requires_grad_(True), tp)
    tx, ts = _t(x).requires_grad_(True), _t(src).requires_grad_(True)
    tout = tatt.apply_attention_layer(tp, tx, ts, _t(x_pe), _t(s_pe), _t(xm),
                                      _t(sm), tcfg)
    assert np.abs(tout.detach().numpy() - np.asarray(jout))[:l_len].max() \
        < 1e-5
    leaves, treedef = jax.tree.flatten((tp, tx, ts))
    tg = jax.tree.unflatten(treedef, torch.autograd.grad(tout, leaves,
                                                         _t(ct)))
    for path, (a, b) in zip(
            jax.tree_util.tree_flatten_with_path(jg)[0],
            zip(jax.tree.leaves(_np_tree(tg)), jax.tree.leaves(jg))):
        scale = max(float(np.abs(b).max()), 1e-30)
        assert np.abs(a - b).max() <= 1e-4 * scale, \
            jax.tree_util.keystr(path[0])


def _tf32(x):
    """Round float32 to TF32 as ``cvt.rna.tf32.f32`` does: the low 13
    mantissa bits rounded away, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_rz(x):
    """Round float32 to TF32 toward zero: the low 13 mantissa bits cleared,
    as kernels C7 and C9 split (``tc_split_rz``) and as the tensor cores
    read the low part they are handed."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_product(eq, a, b, passes, rz=False):
    """An einsum with TF32 operands: one pass (a and b rounded), or the
    three of kernels C7-C9 (a = a_hi + a_lo, the same for b: a_lo b_hi +
    a_hi b_lo + a_hi b_hi, each part rounded to TF32: to nearest as C8's
    cvt.rna, or toward zero with ``rz``, as C7's and C9's), summed in
    float32."""
    tf32 = _tf32_rz if rz else _tf32
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return torch.einsum(eq, ah, bh)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _emulated_dkv(q, k, v, do, s_len, scale, passes):
    """C8's dk, dv with its four products (S, dP, dV, dK) on TF32 operands;
    lse and delta from the plain forward, as the kernel reads them."""
    q, k, v, do = map(_t, (q, k, v, do))
    o, lse = tatt.flash_attention_plain(q, k, v, torch.tensor(s_len), scale,
                                        return_lse=True)
    delta = (do * o).sum(-1)
    valid = (torch.arange(k.shape[0]) < s_len)[:, None, None]
    km, vm = torch.where(valid, k, 0.0), torch.where(valid, v, 0.0)
    s = _tf32_product("lhd,shd->lsh", q, km, passes) * scale
    p = torch.where(valid[None, :, :, 0], torch.exp(s - lse[:, None]), 0.0)
    dp = _tf32_product("lhd,shd->lsh", do, vm, passes)
    ds = p * (dp - delta[:, None])
    dv = _tf32_product("lsh,lhd->shd", p, do, passes)
    dk = _tf32_product("lsh,lhd->shd", ds, q, passes) * scale
    return dk, dv


@pytest.mark.parametrize("L,S,s_len,d", [(200, 150, 120, 132),
                                         (96, 64, 64, 18),
                                         (60, 70, 1, 144)])
def test_three_pass_tf32_keeps_c8_within_its_tolerance(L, S, s_len, d):
    """The error budget of C8's tensor-core route, on the CPU: its 3xTF32
    products keep dk, dv within chip_smoke.py's FLASH_BWD_TOL (2e-5 max
    abs) of ``flash_attention_bwd_plain`` on unit-scale inputs; one TF32
    pass (about three decimal digits) does not. With one valid source row
    dv is the sum of all L upstream rows and dk a cancellation to 0, so
    their size, with the plain version's own float32 rounding, grows with
    L: that case keeps L small."""
    q, k, v, do = _inputs(6, L, S, d)
    scale = 1.0 / math.sqrt(d)
    _, _, ref = _plain_bwd(q, k, v, do, torch.tensor(s_len), scale)
    errs = {}
    for passes in (1, 3):
        got = _emulated_dkv(q, k, v, do, s_len, scale, passes)
        errs[passes] = max(float((a - r).abs().max())
                           for a, r in zip(got, ref[1:]))
    assert errs[3] <= 2e-5 < errs[1], errs


def _emulated_dq(q, k, v, do, s_len, scale, passes):
    """C9's dq with its three products (S, dP, dQ) on TF32 operands split
    toward zero, as the kernel splits them; lse and delta from the plain
    forward, as the kernel reads them."""
    q, k, v, do = map(_t, (q, k, v, do))
    o, lse = tatt.flash_attention_plain(q, k, v, torch.tensor(s_len), scale,
                                        return_lse=True)
    delta = (do * o).sum(-1)
    valid = (torch.arange(k.shape[0]) < s_len)[:, None, None]
    km, vm = torch.where(valid, k, 0.0), torch.where(valid, v, 0.0)
    s = _tf32_product("lhd,shd->lsh", q, km, passes, rz=True) * scale
    p = torch.where(valid[None, :, :, 0], torch.exp(s - lse[:, None]), 0.0)
    dp = _tf32_product("lhd,shd->lsh", do, vm, passes, rz=True)
    ds = p * (dp - delta[:, None])
    return _tf32_product("lsh,shd->lhd", ds, km, passes, rz=True) * scale


def _emulated_fwd(q, k, v, s_len, scale, passes, chunks=1):
    """C7's o and lse with its two products (the logits, P V) on TF32
    operands split toward zero, as the kernel splits them. With ``chunks``
    > 1 the source rows are cut as the kernel cuts them (chunks of whole
    64-row tiles): each live chunk's max, sum and unnormalised output,
    merged in chunk order with weights exp(m - M)."""
    q, k, v = map(_t, (q, k, v))
    n_src = k.shape[0]
    chunk = n_src if chunks == 1 else -(-(-(-n_src // chunks)) // 64) * 64
    parts = []
    for lo in range(0, n_src, chunk):
        hi = min(s_len, lo + chunk)
        if hi <= lo:                       # at or beyond the prefix
            break
        s = _tf32_product("lhd,shd->lsh", q, k[lo:hi], passes,
                          rz=True) * scale
        m = s.amax(1)
        p = torch.exp(s - m[:, None])
        parts.append((m, p.sum(1),
                      _tf32_product("lsh,shd->lhd", p, v[lo:hi], passes,
                                    rz=True)))
    if not parts:
        return torch.zeros_like(q), q.new_full(q.shape[:2], -torch.inf)
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - big) for m, _, _ in parts]
    lsum = sum(l * wz for (_, l, _), wz in zip(parts, w))
    o = sum(oz * wz[..., None] for (_, _, oz), wz in zip(parts, w))
    return o / lsum[..., None], big + torch.log(lsum)


@pytest.mark.parametrize("L,S,s_len,d", [(200, 150, 120, 132),
                                         (96, 64, 64, 18),
                                         (60, 70, 1, 144),
                                         (40, 300, 290, 144)])
def test_three_pass_tf32_keeps_c9_within_its_tolerance(L, S, s_len, d):
    """The error budget of C9's tensor-core route, on the CPU: its 3xTF32
    products keep dq within FLASH_BWD_TOL (2e-5 max abs) of
    ``flash_attention_bwd_plain`` on unit-scale inputs; one TF32 pass does
    not. With one valid source row ds is a cancellation to 0, which one
    pass leaves at ~1e-3 of dp."""
    q, k, v, do = _inputs(7, L, S, d)
    scale = 1.0 / math.sqrt(d)
    _, _, ref = _plain_bwd(q, k, v, do, torch.tensor(s_len), scale)
    errs = {passes: float((_emulated_dq(q, k, v, do, s_len, scale, passes)
                           - ref[0]).abs().max()) for passes in (1, 3)}
    assert errs[3] <= 2e-5 < errs[1], errs


@pytest.mark.parametrize("L,S,s_len,d,chunks", [(200, 150, 120, 132, 1),
                                                (96, 64, 64, 18, 1),
                                                (60, 70, 1, 144, 1),
                                                (64, 1000, 900, 132, 2),
                                                (40, 1000, 100, 144, 4),
                                                (50, 300, 290, 24, 3)])
def test_three_pass_tf32_keeps_c7_within_its_tolerance(L, S, s_len, d,
                                                       chunks):
    """The error budget of C7's tensor-core route, on the CPU: its 3xTF32
    products keep o and lse within 2e-5 max abs of
    ``flash_attention_plain`` on unit-scale inputs, with the source prefix
    in one chunk or merged from several (a prefix that ends inside the
    first of 4 chunks included); one TF32 pass does not. With one valid
    source row o is that row of v, which one pass rounds to TF32."""
    q, k, v, _ = _inputs(8, L, S, d)
    scale = 1.0 / math.sqrt(d)
    ref = tatt.flash_attention_plain(_t(q), _t(k), _t(v),
                                     torch.tensor(s_len), scale,
                                     return_lse=True)
    errs = {}
    for passes in (1, 3):
        got = _emulated_fwd(q, k, v, s_len, scale, passes, chunks)
        errs[passes] = max(float((a - r).abs().max())
                           for a, r in zip(got, ref))
    assert errs[3] <= 2e-5 < errs[1], errs


def test_c7_chunks_of_an_empty_prefix_give_zeros():
    """No live chunk: o is 0 and lse -inf, as the plain version."""
    q, k, v, _ = _inputs(9, 20, 300, 16)
    o, lse = _emulated_fwd(q, k, v, 0, 0.25, 3, chunks=4)
    ref = tatt.flash_attention_plain(_t(q), _t(k), _t(v), torch.tensor(0),
                                     0.25, return_lse=True)
    assert torch.equal(o, ref[0]) and torch.equal(lse, ref[1])


@pytest.mark.parametrize("l,s,h,sms,want", [(1024, 1024, 4, 132, 2),
                                            (2048, 2048, 4, 132, 1),
                                            (4096, 4096, 4, 132, 1),
                                            (512, 512, 4, 132, 4),
                                            (32, 4096, 1, 132, 8),
                                            (300, 200, 4, 132, 1),
                                            (1024, 0, 4, 132, 1),
                                            (0, 1024, 4, 132, 8)])
def test_c7_splits_the_source_where_blocks_leave_the_card_idle(l, s, h, sms,
                                                               want):
    """C7's blocks (64 query rows, a head) run one to an SM; the source
    prefix is cut into chunks of at least 128 rows, at most
    FLASH_MAX_SPLITS, only where they leave SMs idle."""
    assert tatt.flash_fwd_splits(l, s, h, sms) == want
