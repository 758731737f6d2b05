"""Geometry-aware multi-head attention layer, and kernel C7.

Counterpart of ``deformationpyramid_tpu/match/attention.py`` (reference
``GeometryAttentionLayer``, ``correspondence/lepard/transformer.py:10-93``,
and its outlier-rejection twin with the compatibility multiplier). One
functional layer serves both. Single-cloud convention [N, C].

``attention_impl`` routes as in the JAX package: ``'xla'`` is the plain
einsum attention (the name is kept so that the same yaml files load);
``'flash'`` streams the attention through kernel C7
(``csrc/flash_attention.cu``) on CUDA tensors and through its plain version
on CPU tensors, unless a compatibility multiplier is present (NeCo), which
takes the einsum path as in the JAX package. Unlike the JAX package's
flash path, C7 has no shape gate: any L, S and head width up to 144.

The two routes differ on padded QUERY rows only: the einsum path masks
padded source rows where the query row is valid, the streamed path for
every query row. Both are garbage there that downstream masks.

``compute_dtype='bfloat16'`` (inference, the yaml's ``inference_dtype``)
runs every matrix product and einsum of the layer as the JAX package's
``preferred_element_type=f32`` does: bfloat16-rounded operands, float32
accumulation and a float32 result (:func:`matmul_f32acc`,
:func:`einsum_f32acc`); softmax, masks, layer norms and residuals stay
float32, and the streamed route gets float32 q / k / v, as the JAX
package's TPU flash route does, so C7 serves it unchanged. Any other value
is float32, as in the JAX package.

Under autograd the streamed route is differentiable, as the JAX package's
is: C7 then also writes each row's log-sum-exp, and the backward launches
kernels C8 (dK, dV) and C9 (dQ) of ``csrc/flash_attention_bwd.cu``, which
recompute the probabilities from it. Inference (no gradient asked for)
launches C7 alone, with no log-sum-exp output.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.cuda_lib import F, I, Kernel, P, check_cuda, on_cpu
from .position_encoding import embed_rotary

Tensor = torch.Tensor

FLASH_ATTENTION = Kernel("flash_attention_fwd", "dp_flash_attention_fwd",
                         [P, P, P, P, I, I, I, I, F, I, P, P, P])
FLASH_ATTENTION_BWD_DKV = Kernel(
    "flash_attention_bwd_dkv", "dp_flash_attention_bwd_dkv",
    [P, P, P, P, P, P, P, I, I, I, I, F, P, P])
FLASH_ATTENTION_BWD_DQ = Kernel(
    "flash_attention_bwd_dq", "dp_flash_attention_bwd_dq",
    [P, P, P, P, P, P, P, I, I, I, I, F, P])
FLASH_MAX_HEAD_DIM = 144
FLASH_MAX_SPLITS = 8       # source chunks of C7 (``FA_MAX_SPLITS``)


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    feature_dim: int = 528
    n_head: int = 4
    pe_type: str = "rotary"
    # 'bfloat16': bf16 operands and f32 accumulation in every product
    # (inference); anything else float32
    compute_dtype: str = "float32"
    attention_impl: str = "xla"        # 'xla' (plain einsum) | 'flash' (C7)

    def __post_init__(self):
        if self.attention_impl not in ("xla", "flash"):
            raise ValueError(f"attention_impl {self.attention_impl!r}")


_BF16_FORMS: dict[torch.device, str] = {}


def bf16_matmul_form(device: torch.device) -> str:
    """How :func:`matmul_f32acc` computes a bf16 product on ``device``:
    'out_dtype' where this torch has ``torch.mm(a_bf16, b_bf16,
    out_dtype=torch.float32)`` there (bf16 products accumulated in float32
    on the card's tensor cores), else 'upcast' (round to bf16, back to
    float32, a float32 product: the same products, summed in float32).
    Probed once a device."""
    device = torch.device(device)
    if device not in _BF16_FORMS:
        form = "upcast"
        if device.type == "cuda":
            a = torch.ones(16, 16, dtype=torch.bfloat16, device=device)
            try:
                out = torch.mm(a, a, out_dtype=torch.float32)
                if out.dtype == torch.float32 and bool(out[0, 0] == 16):
                    form = "out_dtype"
            except (TypeError, RuntimeError, NotImplementedError):
                pass
        _BF16_FORMS[device] = form
    return _BF16_FORMS[device]


def _round_bf16(a: Tensor) -> Tensor:
    return a.to(torch.bfloat16).to(torch.float32)


def matmul_f32acc(a: Tensor, b: Tensor, bf16: bool) -> Tensor:
    """a @ b in float32; with ``bf16``, from bfloat16-rounded operands with
    float32 accumulation and a float32 result (JAX's ``jnp.matmul`` of
    bf16 operands with ``preferred_element_type=float32``)."""
    if not bf16:
        return a @ b
    if (a.dim() == 2 and b.dim() == 2 and a.device.type == "cuda"
            and not (a.requires_grad or b.requires_grad)
            and bf16_matmul_form(a.device) == "out_dtype"):
        return torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                        out_dtype=torch.float32)
    return _round_bf16(a) @ _round_bf16(b)


def einsum_f32acc(eq: str, a: Tensor, b: Tensor, bf16: bool) -> Tensor:
    """``torch.einsum(eq, a, b)`` in float32; with ``bf16`` from
    bfloat16-rounded operands (as :func:`matmul_f32acc`)."""
    if bf16:
        a, b = _round_bf16(a), _round_bf16(b)
    return torch.einsum(eq, a, b)


def _xavier(gen: torch.Generator, shape: tuple[int, ...]) -> Tensor:
    limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


def init_attention_layer(gen: torch.Generator, cfg: AttentionConfig) -> dict:
    d = cfg.feature_dim
    return {
        "q": _xavier(gen, (d, d)),
        "k": _xavier(gen, (d, d)),
        "v": _xavier(gen, (d, d)),
        "merge": _xavier(gen, (d, d)),
        "mlp1": _xavier(gen, (2 * d, 2 * d)),
        "mlp2": _xavier(gen, (2 * d, d)),
        "ln1": {"g": torch.ones(d), "b": torch.zeros(d)},
        "ln2": {"g": torch.ones(d), "b": torch.zeros(d)},
    }


def _source_length(src_len_or_mask: Tensor | None, s: int,
                   device: torch.device) -> Tensor:
    """The valid source prefix as a 0-d int32 tensor on ``device``, from
    None (all S rows), a 0-d integer tensor, or a valid-prefix bool mask
    [S]. Stays on the device: no host read."""
    if src_len_or_mask is None:
        return torch.full((), s, dtype=torch.int32, device=device)
    if src_len_or_mask.dim() == 0:
        return src_len_or_mask.to(torch.int32)
    if src_len_or_mask.shape != (s,):
        raise ValueError(f"source mask {tuple(src_len_or_mask.shape)}, "
                         f"expected ({s},)")
    return src_len_or_mask.sum().to(torch.int32)


def _plain_logits(q: Tensor, k: Tensor, src_len: Tensor,
                  sm_scale: float) -> tuple[Tensor, Tensor]:
    """Scaled logits [L, S, h] with -inf beyond the valid prefix, and the
    prefix mask [S]. Rows of k beyond the prefix are not read (NaN there
    reaches neither the logits nor a gradient)."""
    valid = torch.arange(k.shape[0], device=q.device) < src_len
    k = torch.where(valid[:, None, None], k, 0.0)
    a = torch.einsum("lhd,shd->lsh", q, k) * sm_scale
    return torch.where(valid[None, :, None], a, -torch.inf), valid


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor,
                          src_len_or_mask: Tensor | None,
                          sm_scale: float, return_lse: bool = False):
    """Plain version of kernel C7: q [L, h, d], k/v [S, h, d] -> [L, h, d],
    softmax over the valid source prefix for every query row; an empty
    prefix gives zeros. With ``return_lse`` also the rows' log-sum-exp
    [L, h] of the scaled logits (-inf for an empty prefix)."""
    s = k.shape[0]
    if s == 0:
        o = torch.zeros_like(q)
        return (o, q.new_full(q.shape[:2], -torch.inf)) if return_lse else o
    src_len = _source_length(src_len_or_mask, s, q.device)
    a, valid = _plain_logits(q, k, src_len, sm_scale)
    m = a.max(dim=1, keepdim=True).values
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(a - m)
    denom = p.sum(dim=1)                                   # [L, h]
    o = torch.einsum("lsh,shd->lhd", p,
                     torch.where(valid[:, None, None], v, 0.0))
    o = torch.where(denom[..., None] > 0,
                    o / denom.clamp_min(1e-38)[..., None], 0.0)
    if not return_lse:
        return o
    lse = torch.where(denom > 0, m[:, 0] + torch.log(denom.clamp_min(1e-38)),
                      -torch.inf)
    return o, lse


def flash_attention_bwd_plain(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                              lse: Tensor, do: Tensor,
                              src_len_or_mask: Tensor | None,
                              sm_scale: float
                              ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain version of kernels C8 and C9, from the formulas and not through
    autograd: with p = exp(q k^T * sm_scale - lse) over the valid source
    prefix and delta = rowsum(do * o),

        dv = p^T do,  ds = p * (do v^T - delta),
        dk = ds^T q * sm_scale,  dq = ds k * sm_scale.

    Source rows beyond the prefix get zero dk, dv and are not read; an
    empty prefix gives zero dq. Returns (dq, dk, dv)."""
    s = k.shape[0]
    if s == 0 or q.shape[0] == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    src_len = _source_length(src_len_or_mask, s, q.device)
    a, valid = _plain_logits(q, k, src_len, sm_scale)
    # an empty prefix has lse = -inf: exp(-inf - 0), not exp(-inf + inf)
    shift = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.exp(a - shift[:, None, :])                   # [L, S, h]
    vm = torch.where(valid[:, None, None], v, 0.0)
    km = torch.where(valid[:, None, None], k, 0.0)
    delta = (do * o).sum(dim=-1)                           # [L, h]
    dv = torch.einsum("lsh,lhd->shd", p, do)
    dp = torch.einsum("lhd,shd->lsh", do, vm)
    ds = p * (dp - delta[:, None, :])
    dk = torch.einsum("lsh,lhd->shd", ds, q) * sm_scale
    dq = torch.einsum("lsh,shd->lhd", ds, km) * sm_scale
    return dq, dk, dv


def _check_flash_shapes(name: str, q: Tensor, k: Tensor, v: Tensor) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or q.shape[1:] != k.shape[1:]:
        raise ValueError(f"{name}: expected q [L, h, d] and k, v "
                         f"[S, h, d], got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")
    if not 1 <= q.shape[2] <= FLASH_MAX_HEAD_DIM:
        raise ValueError(f"{name}: head width {q.shape[2]} outside "
                         f"[1, {FLASH_MAX_HEAD_DIM}]")


def _device_source_length(name: str, src_len_or_mask: Tensor | None, s: int,
                          q: Tensor) -> Tensor:
    src_len = _source_length(src_len_or_mask, s, q.device).contiguous()
    check_cuda(name, src_len, dtype=torch.int32)
    if src_len.device != q.device:
        raise ValueError(f"{name}: the source length lies on "
                         f"{src_len.device}, q on {q.device}")
    return src_len


def flash_fwd_splits(l: int, s: int, h: int, sms: int) -> int:
    """How many chunks C7 cuts the source rows into: its (64-row query
    tile, head) blocks run one to an SM, and where they leave SMs idle the
    source prefix is split so that the chunks fill them, at least 128
    source rows (two tiles) a chunk. Chosen from S, not from the valid
    prefix (which lies on the device): chunks beyond it exit at once."""
    blocks = -(-l // 64) * h
    return max(1, min(sms // max(blocks, 1), s // 128, FLASH_MAX_SPLITS))


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor,
                         src_len_or_mask: Tensor | None,
                         sm_scale: float, return_lse: bool = False):
    """Kernel C7 (``csrc/flash_attention.cu``) on CUDA tensors. With
    ``return_lse`` the kernel also writes the rows' log-sum-exp [L, h],
    which the backward kernels need: (o, lse)."""
    return _flash_attention_launch(q, k, v, src_len_or_mask, sm_scale,
                                   return_lse, None)


def _flash_attention_launch(q: Tensor, k: Tensor, v: Tensor,
                            src_len_or_mask: Tensor | None, sm_scale: float,
                            return_lse: bool, splits: int | None):
    """C7 with its source chunks given (``splits``; None: as
    ``flash_fwd_splits`` chooses them for this card)."""
    _check_flash_shapes("flash_attention", q, k, v)
    l, h, d = q.shape
    s = k.shape[0]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_cuda("flash_attention", q, k, v)
    src_len = _device_source_length("flash_attention", src_len_or_mask, s, q)
    if splits is None:
        splits = flash_fwd_splits(l, s, h, _sm_count(q.device))
    out = torch.empty_like(q)
    lse = q.new_empty((l, h)) if return_lse else None
    part = q.new_empty((splits, l, h, d + 2)) if splits > 1 else None
    FLASH_ATTENTION.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           src_len.data_ptr(), l, s, h, d, float(sm_scale),
                           splits, part.data_ptr() if part is not None
                           else None, out.data_ptr(),
                           lse.data_ptr() if return_lse else None)
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q: Tensor, k: Tensor, v: Tensor, o: Tensor,
                             lse: Tensor, do: Tensor,
                             src_len_or_mask: Tensor | None,
                             sm_scale: float
                             ) -> tuple[Tensor, Tensor, Tensor]:
    """Kernels C8 and C9 (``csrc/flash_attention_bwd.cu``) on CUDA tensors:
    (dq, dk, dv) of C7's output for the upstream gradient ``do``, from C7's
    inputs, its output ``o`` and the log-sum-exp ``lse`` it wrote."""
    name = "flash_attention_bwd"
    _check_flash_shapes(name, q, k, v)
    l, h, d = q.shape
    s = k.shape[0]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (l, h):
        raise ValueError(f"{name}: o {tuple(o.shape)}, do {tuple(do.shape)}, "
                         f"lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    check_cuda(name, q, k, v, o, do, lse)
    delta = (do * o).sum(dim=-1)                           # [L, h]
    src_len = _device_source_length(name, src_len_or_mask, s, q)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), src_len.data_ptr(), l, s, h,
              d, float(sm_scale))
    FLASH_ATTENTION_BWD_DKV.launch(*common, dk.data_ptr(), dv.data_ptr())
    FLASH_ATTENTION_BWD_DQ.launch(*common, dq.data_ptr())
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """C7 under autograd, with C8 and C9 as its backward (the JAX package's
    stock kernel ships the same split as its VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, src_len_or_mask, sm_scale):
        src_len = _source_length(src_len_or_mask, k.shape[0], q.device)
        if not any(ctx.needs_input_grad[:3]):
            return flash_attention_cuda(q, k, v, src_len, sm_scale)
        o, lse = flash_attention_cuda(q, k, v, src_len, sm_scale,
                                      return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse, src_len)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, src_len = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse, do, src_len,
                                              ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor,
                    src_len_or_mask: Tensor | None,
                    sm_scale: float) -> Tensor:
    """softmax(q k^T * sm_scale) v over the valid source prefix, streamed:
    kernel C7 on CUDA tensors, its plain version on CPU tensors."""
    tensors = [t for t in (q, k, v, src_len_or_mask) if t is not None]
    if on_cpu(*tensors):
        return flash_attention_plain(q, k, v, src_len_or_mask, sm_scale)
    return _FlashAttention.apply(q, k, v, src_len_or_mask, sm_scale)


def _layer_norm(x: Tensor, p: dict, eps: float = 1e-5) -> Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def apply_attention_layer(p: dict, x: Tensor, source: Tensor,
                          x_pe: Tensor | None, source_pe: Tensor | None,
                          x_mask: Tensor | None, source_mask: Tensor | None,
                          cfg: AttentionConfig,
                          compatibility: Tensor | None = None) -> Tensor:
    """x [L, C] queries attend into source [S, C]; returns [L, C].

    pe handling matches the reference: 'sinusoidal' adds pe before q/k
    projection; 'rotary' rotates the projected q/k; 'none' skips pe.
    ``compatibility`` [L, S] multiplies raw attention logits (NeCo).
    """
    h, dim = cfg.n_head, cfg.feature_dim // cfg.n_head
    bf16 = cfg.compute_dtype == "bfloat16"

    def mm(a, b):
        return matmul_f32acc(a, b, bf16)

    q_in, k_in, v_in = x, source, source
    if cfg.pe_type == "sinusoidal" and x_pe is not None:
        q_in = q_in + x_pe
        k_in = k_in + source_pe
    qw = mm(q_in, p["q"])
    kw = mm(k_in, p["k"])
    vw = mm(v_in, p["v"])
    if cfg.pe_type == "rotary" and x_pe is not None:
        qw = embed_rotary(qw, x_pe[..., 0], x_pe[..., 1])
        kw = embed_rotary(kw, source_pe[..., 0], source_pe[..., 1])

    L, S = qw.shape[0], kw.shape[0]
    qw = qw.reshape(L, h, dim)
    kw = kw.reshape(S, h, dim)
    vw = vw.reshape(S, h, dim)

    if cfg.attention_impl == "flash" and compatibility is None:
        # float32 q / k / v with either compute_dtype, as the JAX package's
        # flash route takes them
        o = flash_attention(qw, kw, vw, source_mask, 1.0 / math.sqrt(dim))
    else:
        a = einsum_f32acc("lhd,shd->lsh", qw, kw, bf16)
        if compatibility is not None:
            a = a * compatibility[..., None]
        if source_mask is not None:
            q_m = (x_mask if x_mask is not None
                   else torch.ones(L, dtype=torch.bool, device=x.device))
            drop = q_m[:, None] & (~source_mask)[None, :]
            a = torch.where(drop[..., None], -torch.inf, a)
        a = a / math.sqrt(dim)
        a = torch.softmax(a, dim=1)
        o = einsum_f32acc("lsh,shd->lhd", a, vw, bf16)
    o = o.reshape(L, h * dim)

    message = _layer_norm(mm(o, p["merge"]), p["ln1"])
    message = torch.cat([x, message], dim=-1)
    message = mm(torch.relu(mm(message, p["mlp1"])), p["mlp2"])
    message = _layer_norm(message, p["ln2"])
    return x + message
