"""Nearest-neighbour search: exact 1-NN in one or both directions.

Counterpart of ``deformationpyramid_tpu/ops/knn.py``: kernel C1
``nn_dual`` (``csrc/nn_dual.cu``, both directions, the chamfer's sweep) and
kernel C14 ``nn_argmin`` (``csrc/nn_argmin.cu``, one direction, the
point-to-plane loss's). The chamfer loss needs only the argmin indices; the
differentiable distance is rebuilt from gathered points
(``ops/chamfer.py``), so nothing here has a gradient.

Distances are the exact difference form sum((q - p)^2), in float32 with no
TF32, and never |q|^2 + |p|^2 - 2 q.p: the cancellation of the expanded
form floors the solver's chamfer loss (the JAX package's round-2 finding,
``ops/knn.py`` module docstring). Ties go to the first index; invalid
database rows never win.
"""
from __future__ import annotations

import torch

from .cuda_lib import I, Kernel, P, check_cuda, on_cpu

Tensor = torch.Tensor

NN_DUAL = Kernel("nn_dual", "dp_nn_dual", [P, P, P, P, I, I, I, P, P, P, P])
NN_ARGMIN = Kernel("nn_argmin", "dp_nn_argmin", [P, P, P, I, I, P, P])


def nn_argmin_plain(x: Tensor, y: Tensor, y_valid: Tensor | None = None,
                    chunk: int | None = None) -> tuple[Tensor, Tensor]:
    """Plain version of kernel C14: the exact squared distance summed left
    to right, (dx*dx + dy*dy) + dz*dz, then ``torch.min`` (the first index
    of a tie). Query rows go in chunks of ``chunk`` (default: ~2^25
    distances a chunk), so that the [rows, M] temporaries stay bounded at
    40k x 40k; every distance is computed alike in any chunking, so the
    result does not depend on it."""
    n, m = x.shape[0], y.shape[0]
    if n == 0 or m == 0:
        return (torch.full((n,), torch.inf, dtype=x.dtype, device=x.device),
                torch.zeros(n, dtype=torch.int64, device=x.device))
    if chunk is None:
        chunk = max(1, (1 << 25) // m)
    sq, idx = [], []
    for s in range(0, n, chunk):
        diff = x[s:s + chunk, None, :] - y[None, :, :]
        d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
            + diff[..., 2] * diff[..., 2]
        if y_valid is not None:
            d = torch.where(y_valid[None, :], d, torch.inf)
        part = torch.min(d, dim=1)
        sq.append(part.values)
        idx.append(part.indices)
    return torch.cat(sq), torch.cat(idx)


def nn_argmin_cuda(x: Tensor, y: Tensor, y_valid: Tensor | None = None
                   ) -> tuple[Tensor, Tensor]:
    """Kernel C14 (``csrc/nn_argmin.cu``) on CUDA tensors."""
    n, m = x.shape[0], y.shape[0]
    x = x.contiguous()
    y = y.contiguous()
    check_cuda("nn_argmin", x, y)
    if y_valid is not None:
        y_valid = y_valid.contiguous()
        check_cuda("nn_argmin", x, y_valid, dtype=None)
        if y_valid.shape != (m,) or y_valid.dtype != torch.bool:
            raise ValueError("nn_argmin: expected a bool y_valid [M]")
    if x.shape != (n, 3) or y.shape != (m, 3):
        raise ValueError("nn_argmin: expected f32 x [N, 3] and y [M, 3]")
    sq = torch.empty(n, dtype=torch.float32, device=x.device)
    idx = torch.empty(n, dtype=torch.int64, device=x.device)
    NN_ARGMIN.launch(x.data_ptr(), y.data_ptr(),
                     None if y_valid is None else y_valid.data_ptr(), n, m,
                     sq.data_ptr(), idx.data_ptr())
    return sq, idx


def nn_argmin(x: Tensor, y: Tensor, y_valid: Tensor | None = None
              ) -> tuple[Tensor, Tensor]:
    """1-NN of each row of ``x`` [N, 3] in ``y`` [M, 3]: (sq_dist [N],
    idx [N] int64). Kernel C14 on CUDA tensors at every size (the JAX
    package's ``_nn_kernel`` from N*M >= 4096^2 on a TPU), its plain
    version on CPU tensors. ``y_valid`` masks database rows out (True =
    real point); a query with no valid candidate gets (+inf, 0)."""
    tensors = [t for t in (x, y, y_valid) if t is not None]
    if on_cpu(*tensors):
        return nn_argmin_plain(x, y, y_valid)
    return nn_argmin_cuda(x, y, y_valid)


def nn_argmin_dual_plain(x: Tensor, y: Tensor,
                         x_valid: Tensor | None = None,
                         y_valid: Tensor | None = None):
    """Plain version of kernel C1: both directions from one [..., N, M]
    difference tensor; leading slot axes ([B, N, 3] / [B, M, 3] with
    [B, N] / [B, M] masks) are independent pairs, each computed as the
    one-pair call computes it. ``torch.min`` returns the first index of a
    tie."""
    d = ((x[..., :, None, :] - y[..., None, :, :]) ** 2).sum(-1)
    dx = d if y_valid is None else torch.where(y_valid[..., None, :], d,
                                               torch.inf)
    dy = d if x_valid is None else torch.where(x_valid[..., :, None], d,
                                               torch.inf)
    sq_x, idx_x = torch.min(dx, dim=-1)
    sq_y, idx_y = torch.min(dy, dim=-2)
    return sq_x, idx_x, sq_y, idx_y


def nn_argmin_dual_cuda(x: Tensor, y: Tensor,
                        x_valid: Tensor | None = None,
                        y_valid: Tensor | None = None):
    """Kernel C1 (``csrc/nn_dual.cu``) on CUDA tensors: one pair, x [N, 3]
    and y [M, 3], or B slots, x [B, N, 3] and y [B, M, 3] with masks
    [B, N] / [B, M], in one launch either way."""
    lead = x.shape[:-2]
    if x.dim() not in (2, 3) or y.shape[:-2] != lead:
        raise ValueError("nn_dual: expected x [N, 3] and y [M, 3], or "
                         "x [B, N, 3] and y [B, M, 3]")
    b = lead[0] if lead else 1
    n, m = x.shape[-2], y.shape[-2]
    xv = (torch.ones(lead + (n,), dtype=torch.bool, device=x.device)
          if x_valid is None else x_valid.contiguous())
    yv = (torch.ones(lead + (m,), dtype=torch.bool, device=y.device)
          if y_valid is None else y_valid.contiguous())
    x = x.contiguous()
    y = y.contiguous()
    check_cuda("nn_dual", x, y)
    check_cuda("nn_dual", x, xv, yv, dtype=None)
    if x.shape != lead + (n, 3) or y.shape != lead + (m, 3) \
            or xv.shape != lead + (n,) or yv.shape != lead + (m,) \
            or xv.dtype != torch.bool or yv.dtype != torch.bool:
        raise ValueError("nn_dual: expected f32 x [..., N, 3], y [..., M, 3]"
                         " and bool masks [..., N], [..., M]")
    sq_x = torch.empty(lead + (n,), dtype=torch.float32, device=x.device)
    idx_x = torch.empty(lead + (n,), dtype=torch.int64, device=x.device)
    sq_y = torch.empty(lead + (m,), dtype=torch.float32, device=x.device)
    idx_y = torch.empty(lead + (m,), dtype=torch.int64, device=x.device)
    NN_DUAL.launch(x.data_ptr(), y.data_ptr(), xv.data_ptr(), yv.data_ptr(),
                   b, n, m, sq_x.data_ptr(), idx_x.data_ptr(),
                   sq_y.data_ptr(), idx_y.data_ptr())
    return sq_x, idx_x, sq_y, idx_y


# The JAX package's dual-sweep variants (ops/knn.py nn_argmin_dual_pallas):
# one function in several TPU operand layouts and selection encodings, v1
# the exact first-index semantics the others approximate. C1 computes v1
# for every one of them.
DUAL_VARIANTS = ("v1", "v2", "v3", "v4", "v4h")


def nn_argmin_dual(x: Tensor, y: Tensor,
                   x_valid: Tensor | None = None,
                   y_valid: Tensor | None = None,
                   variant: str | None = None):
    """Both-direction 1-NN: (sq_x2y [N], idx_x2y [N], sq_y2x [M],
    idx_y2x [M]). Kernel C1 on CUDA tensors, its plain version on CPU
    tensors. With a leading slot axis (x [B, N, 3], y [B, M, 3], masks
    [B, N] / [B, M]: the vmapped sweep of the JAX package's streaming
    solver) every output gains it, and C1 answers all B slots in one
    launch. ``x_valid``/``y_valid`` mask padded rows out of the search
    in the other direction (True = real point). ``variant`` names one of
    the JAX package's sweep kernels (``DUAL_VARIANTS``); each is C1's
    function (v2's [3, M] layout and v3 / v4's packed or matrix-unit
    distances served the TPU), so every one is sent to C1."""
    if variant is not None and variant not in DUAL_VARIANTS:
        raise ValueError(f"nn_argmin_dual: unknown variant {variant!r}; "
                         f"expected one of {DUAL_VARIANTS}")
    tensors = [t for t in (x, y, x_valid, y_valid) if t is not None]
    if on_cpu(*tensors):
        return nn_argmin_dual_plain(x, y, x_valid, y_valid)
    return nn_argmin_dual_cuda(x, y, x_valid, y_valid)
