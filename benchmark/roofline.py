"""The least time the card could take for a function, and its peaks.

Frozen copy of ``chip_smoke.py``'s bound arithmetic (``bound``,
``tc_bound``, ``level_mlp_flops``, ``level_bounds``, ``flash_bound``,
``flash_bwd_bounds``, ``c14_bound`` and C1's bound in ``c1_case``) at
commit 52465dd567ae528633903efcb67c623d9d527dd1, with the time in seconds
instead of ms. Each counts the function's work from its shapes, with each
input read once and each output written once, whatever a kernel reads
again. The benchmark keeps its own copy so that a change to the program
cannot change the yardstick.

Peaks: one H100 SXM (NVIDIA's data sheet, dense, at the full 700 W power
limit): 3.35 TB/s of device memory, 67 TFLOP/s of float32 outside the
tensor cores, 495 TFLOP/s of TF32 on them. ``mfu`` divides by the TF32
peak: exact float32 work done as 3xTF32 can exceed the 67 TFLOP/s FMA
peak, never the 495 one.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
MFU_PEAK_FLOP_PER_S = TF32_FLOP_PER_S


def bound(nbytes: float, flops: float,
          flop_per_s: float = F32_FLOP_PER_S) -> dict:
    """The larger of the bytes over the memory rate and the operations
    over the rate of their type (float32 outside the tensor cores unless
    ``flop_per_s`` says other), in seconds."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = flops / flop_per_s
    return dict(bound_s=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def tc_bound(nbytes: float, flops: float, wide: float) -> dict:
    """A function whose ``wide`` flops run as 3xTF32 on the tensor cores
    (three passes at the TF32 rate), the rest at the f32 rate."""
    tc_s = 3.0 * wide / TF32_FLOP_PER_S + (flops - wide) / F32_FLOP_PER_S
    bytes_s = nbytes / HBM_BYTES_PER_S
    return dict(bound_s=max(bytes_s, tc_s),
                bound_by="bytes" if bytes_s >= tc_s else "operations",
                f32_bound_s=bound(nbytes, flops)["bound_s"])


def level_mlp_flops(n: int, width: int, depth: int, heads: int) -> float:
    """Multiply-adds of one pyramid level's MLP over n points, as flops:
    6 -> width, depth - 1 hidden layers, width -> heads."""
    return 2.0 * n * (6 * width + (depth - 1) * width * width
                      + width * heads)


def level_heads(rot_dim: int, motion: str, nonrigidity: bool) -> int:
    return ((0 if motion == "sflow" else rot_dim) + 3
            + (1 if motion == "Sim3" else 0) + (1 if nonrigidity else 0))


def nn_dual_bound(b: int, n: int, m: int) -> dict:
    """C1's function on b slots of n x m points: 8 flops a pair of points;
    the points, the masks and both outputs (distance and index) once."""
    return bound(b * (n + m) * (12 + 1 + 4 + 8), 8.0 * b * n * m)


def c14_bound(n: int, m_valid: int, m: int) -> dict:
    """One-way 1-NN: 8 flops a (query, valid row) pair; the points, the
    mask and both outputs once."""
    return bound(n * 12 + m * 13 + n * 12, 8.0 * n * m_valid)


def flash_bound(L: int, src_len: int, h: int, d: int) -> dict:
    """Streamed attention forward: two products of 2 L src_len h d flops
    each as 3xTF32; q read and o written (L rows), k and v read up to the
    valid prefix."""
    nbytes = 4.0 * (2 * L + 2 * src_len) * h * d
    ops = 4.0 * L * src_len * h * d
    return dict(bound(nbytes, 3 * ops, TF32_FLOP_PER_S),
                f32_bound_s=bound(nbytes, ops)["bound_s"])


def flash_bwd_bounds(L: int, S: int, src_len: int, h: int, d: int) -> dict:
    """Its backward: five products of 10 L src_len h d flops, 6 : 4
    between the dk/dv and the dq halves, each as 3xTF32."""
    rows = 4.0 * h * d
    read = (2 * L + 2 * src_len) * rows + 8.0 * L * h
    ops = L * src_len * h * d
    out = {}
    for name, nbytes, share in (("dkv", read + 2 * S * rows, 6.0),
                                ("dq", read + L * rows, 4.0)):
        out[name] = dict(bound(nbytes, 3 * share * ops, TF32_FLOP_PER_S),
                         f32_bound_s=bound(nbytes, share * ops)["bound_s"])
    return out


def flash_bound_s(L, S, valid, h: int, d: int, backward: bool):
    """:func:`flash_bound` (and with ``backward`` the two halves of
    :func:`flash_bwd_bounds` added) in seconds, for ``L`` valid query rows
    and ``valid`` source rows of ``S``."""
    ops = L * valid * h * d
    rows = 4.0 * h * d
    out = max(4.0 * (2 * L + 2 * valid) * h * d / HBM_BYTES_PER_S,
              3 * 4.0 * ops / TF32_FLOP_PER_S)
    if backward:
        read = (2 * L + 2 * valid) * rows + 8.0 * L * h
        out = out + max((read + 2 * S * rows) / HBM_BYTES_PER_S,
                        3 * 6.0 * ops / TF32_FLOP_PER_S) \
            + max((read + L * rows) / HBM_BYTES_PER_S,
                  3 * 4.0 * ops / TF32_FLOP_PER_S)
    return out


def transformer_attention_bound_s(layer_types, src_len: int, tgt_len: int,
                                  cap: int, h: int, d: int,
                                  backward: bool) -> float:
    """:func:`flash_bound_s` of every attention of one pass of the
    matcher's transformer over the valid rows of both clouds (padded to
    ``cap``): a ``self`` layer attends each cloud into itself, a ``cross``
    layer the source into the target and the target into the source; the
    other layers hold no attention over the clouds. Padded query rows are
    no work the pass needs."""
    calls = {"self": ((src_len, src_len), (tgt_len, tgt_len)),
             "cross": ((src_len, tgt_len), (tgt_len, src_len))}
    return float(sum(flash_bound_s(q, cap, s, h, d, backward)
                     for kind in layer_types for q, s in calls.get(kind, ())))


def ndp_iteration_flops(n: int, m: int, width: int, depth: int,
                        heads: int) -> float:
    """FLOPs one chamfer-mode solver iteration of one pair needs: the
    level MLP forward and backward (3x the forward) over the n sampled
    source points, and the two-way 1-NN over n x m points (8 a pair)."""
    return 3.0 * level_mlp_flops(n, width, depth, heads) + 8.0 * n * m


def ldmk_iteration_flops(n_valid: int, width: int, depth: int,
                         heads: int) -> float:
    """FLOPs one landmark-mode iteration needs: the MLP forward and
    backward over the valid landmark rows."""
    return 3.0 * level_mlp_flops(n_valid, width, depth, heads)


def mfu_pct(flops: float, seconds: float) -> float | None:
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / MFU_PEAK_FLOP_PER_S


def roofline_pct(bound_s: float, device_s: float) -> float | None:
    """A share of the roofline: the least time over the device time spent;
    nothing where nothing ran."""
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s
