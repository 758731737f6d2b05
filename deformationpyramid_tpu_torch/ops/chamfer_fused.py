"""The truncated L1 chamfer with its gradient built in one kernel call.

Counterpart of ``deformationpyramid_tpu/ops/chamfer_fused.py``
(``chamfer_l1_fused``), the opt-in ``use_fused_chamfer`` loss of
``solve/registration.py``. Kernel **C12** ``chamfer_fused``
(``csrc/chamfer_fused.cu``, two launches, no atomics) computes what the JAX
package's ``_kernel`` computes: each query row's nearest target column
(exact squared difference, first index on ties) and each column's nearest
row, the truncated row and column sums of the square roots, and the
column direction's gradient scattered onto the winning rows. The loss is

    rsum / x_len + csum / y_len

and its gradient flows to the query cloud only (the solver's warped
points; the target sample is constant, as in the JAX package): the row
direction from the row minima and arguments, the column direction from
the kernel's scattered term. On CPU tensors the plain version runs.
"""
from __future__ import annotations

import torch

from .cuda_lib import F, I, Kernel, P, check_cuda, on_cpu

Tensor = torch.Tensor

CHAMFER_FUSED = Kernel("chamfer_fused", "dp_chamfer_fused",
                       [P, P, P, P, I, I, F, P, P, P, P, P, P])
_BIG = 3.0e38
_FLOOR = 1e-16


def _masks(w: Tensor, y: Tensor, x_valid: Tensor | None,
           y_valid: Tensor | None) -> tuple[Tensor, Tensor]:
    xv = torch.ones(w.shape[0], dtype=torch.bool, device=w.device) \
        if x_valid is None else x_valid.to(torch.bool).contiguous()
    yv = torch.ones(y.shape[0], dtype=torch.bool, device=y.device) \
        if y_valid is None else y_valid.to(torch.bool).contiguous()
    return xv, yv


def chamfer_fused_plain(w: Tensor, y: Tensor, x_valid: Tensor,
                        y_valid: Tensor, trunc: float):
    """Plain version of kernel C12: (sums [2] = (row sum, column sum),
    cgrad [N, 3], rmin [N], rarg [N])."""
    d = ((w[:, None, 0] - y[None, :, 0]) ** 2
         + (w[:, None, 1] - y[None, :, 1]) ** 2) \
        + (w[:, None, 2] - y[None, :, 2]) ** 2
    d = (d + torch.where(x_valid, 0.0, _BIG)[:, None]) \
        + torch.where(y_valid, 0.0, _BIG)[None, :]
    rmin, rarg = torch.min(d, dim=1)       # the first index of a tie
    cmin, carg = torch.min(d, dim=0)
    rmin = torch.clamp_min(rmin, 0.0)
    keep_c = cmin < trunc
    s = torch.where(keep_c, 1.0 / torch.sqrt(torch.clamp_min(cmin, _FLOOR)),
                    0.0)
    cnt = torch.zeros(w.shape[0], dtype=w.dtype, device=w.device) \
        .index_add_(0, carg, s)
    sy = torch.zeros_like(w).index_add_(0, carg, s[:, None] * y)
    cgrad = w * cnt[:, None] - sy
    rsum = torch.sum(torch.where(rmin < trunc,
                                 torch.sqrt(torch.clamp_min(rmin, _FLOOR)),
                                 0.0))
    csum = torch.sum(torch.where(keep_c,
                                 torch.sqrt(torch.clamp_min(cmin, _FLOOR)),
                                 0.0))
    return torch.stack([rsum, csum]), cgrad, rmin, rarg


def chamfer_fused(w: Tensor, y: Tensor, x_valid: Tensor | None = None,
                  y_valid: Tensor | None = None, trunc: float = 1e9):
    """The sweep of :func:`chamfer_l1_fused`: (sums [2], cgrad [N, 3],
    rmin [N], rarg [N] int64) for the query cloud w [N, 3] against the
    target y [M, 3]; invalid rows and columns never win and never count.
    Kernel C12 on CUDA tensors, :func:`chamfer_fused_plain` on CPU
    tensors."""
    xv, yv = _masks(w, y, x_valid, y_valid)
    w = w.to(torch.float32).contiguous()
    y = y.to(torch.float32).contiguous()
    if on_cpu(w, y, xv, yv):
        return chamfer_fused_plain(w, y, xv, yv, trunc)
    check_cuda("chamfer_fused", w, y)
    check_cuda("chamfer_fused", w, xv, yv, dtype=None)
    n, m = w.shape[0], y.shape[0]
    if w.shape != (n, 3) or y.shape != (m, 3) or xv.shape != (n,) \
            or yv.shape != (m,) or n == 0 or m == 0:
        raise ValueError("chamfer_fused: expected w [N, 3], y [M, 3] and "
                         "masks [N], [M], N, M > 0")
    f32 = dict(dtype=torch.float32, device=w.device)
    rmin = torch.empty(n, **f32)
    rarg = torch.empty(n, dtype=torch.int64, device=w.device)
    cmin = torch.empty(m, **f32)
    carg = torch.empty(m, dtype=torch.int64, device=w.device)
    cgrad = torch.empty((n, 3), **f32)
    sums = torch.empty(2, **f32)
    CHAMFER_FUSED.launch(w.data_ptr(), y.data_ptr(), xv.data_ptr(),
                         yv.data_ptr(), n, m, float(trunc), rmin.data_ptr(),
                         rarg.data_ptr(), cmin.data_ptr(), carg.data_ptr(),
                         cgrad.data_ptr(), sums.data_ptr())
    return sums, cgrad, rmin, rarg


class _ChamferL1Fused(torch.autograd.Function):

    @staticmethod
    def forward(ctx, w, y, xv, yv, x_len, y_len, trunc):
        sums, cgrad, rmin, rarg = chamfer_fused(w.detach(), y, xv, yv, trunc)
        ctx.save_for_backward(w, y, cgrad, rmin, rarg, x_len, y_len)
        ctx.trunc = trunc
        return sums[0] / x_len + sums[1] / y_len

    @staticmethod
    def backward(ctx, g):
        w, y, cgrad, rmin, rarg, x_len, y_len = ctx.saved_tensors
        inv = torch.where(rmin < ctx.trunc,
                          1.0 / torch.sqrt(torch.clamp_min(rmin, _FLOOR)),
                          0.0)
        grad_w = g * ((w - y[rarg]) * inv[:, None] / x_len + cgrad / y_len)
        return grad_w, None, None, None, None, None, None


def chamfer_l1_fused(w: Tensor, y: Tensor, x_valid: Tensor | None = None,
                     y_valid: Tensor | None = None,
                     x_length: Tensor | float | None = None,
                     y_length: Tensor | float | None = None,
                     trunc: float = 1e9) -> Tensor:
    """Truncated chamfer L1 loss of w [N, 3] against the constant y [M, 3]
    (the same value as ``ops.chamfer.truncated_chamfer`` up to float32
    summation order); the gradient flows to ``w`` only. ``x_length`` /
    ``y_length`` default to the mask sums, or N / M."""
    n, m = w.shape[0], y.shape[0]
    if x_length is None:
        x_length = x_valid.sum() if x_valid is not None else n
    if y_length is None:
        y_length = y_valid.sum() if y_valid is not None else m
    x_len = torch.as_tensor(x_length, dtype=torch.float32, device=w.device)
    y_len = torch.as_tensor(y_length, dtype=torch.float32, device=w.device)
    xv, yv = _masks(w, y, x_valid, y_valid)
    return _ChamferL1Fused.apply(w, y.detach(), xv, yv, x_len, y_len,
                                 float(trunc))
