"""Nearest-neighbour search: exact 1-NN in one or both directions.

Counterpart of ``deformationpyramid_tpu/ops/knn.py``. The chamfer loss
needs only the argmin indices; the differentiable distance is rebuilt from
gathered points (``ops/chamfer.py``), so nothing here has a gradient.

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

NN_DUAL = Kernel("nn_dual", "dp_nn_dual", [P, P, P, P, I, I, P, P, P, P])


def nn_argmin(x: Tensor, y: Tensor, y_valid: Tensor | None = None
              ) -> tuple[Tensor, Tensor]:
    """1-NN of each row of ``x`` [N, 3] in ``y`` [M, 3]: (sq_dist [N],
    idx [N]). Plain PyTorch on every device; the one-direction streaming
    kernel (``ops/knn.py`` ``_nn_kernel``) is not ported yet, and the solver
    path uses :func:`nn_argmin_dual`."""
    d = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    if y_valid is not None:
        d = torch.where(y_valid[None, :], d, torch.inf)
    sq, idx = torch.min(d, dim=1)
    return sq, idx


def nn_argmin_dual_plain(x: Tensor, y: Tensor,
                         x_valid: Tensor | None = None,
                         y_valid: Tensor | None = None):
    """Plain version of kernel C1: both directions from one [N, M]
    difference tensor. ``torch.min`` returns the first index of a tie."""
    d = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    dx = d if y_valid is None else torch.where(y_valid[None, :], d, torch.inf)
    dy = d if x_valid is None else torch.where(x_valid[:, None], d, torch.inf)
    sq_x, idx_x = torch.min(dx, dim=1)
    sq_y, idx_y = torch.min(dy, dim=0)
    return sq_x, idx_x, sq_y, idx_y


def nn_argmin_dual_cuda(x: Tensor, y: Tensor,
                        x_valid: Tensor | None = None,
                        y_valid: Tensor | None = None):
    """Kernel C1 (``csrc/nn_dual.cu``) on CUDA tensors."""
    n, m = x.shape[0], y.shape[0]
    xv = (torch.ones(n, dtype=torch.bool, device=x.device) if x_valid is None
          else x_valid.contiguous())
    yv = (torch.ones(m, dtype=torch.bool, device=y.device) if y_valid is None
          else y_valid.contiguous())
    x = x.contiguous()
    y = y.contiguous()
    check_cuda("nn_dual", x, y)
    check_cuda("nn_dual", x, xv, yv, dtype=None)
    if x.shape != (n, 3) or y.shape != (m, 3) or xv.shape != (n,) \
            or yv.shape != (m,) or xv.dtype != torch.bool \
            or yv.dtype != torch.bool:
        raise ValueError("nn_dual: expected f32 x [N,3], y [M,3] and bool "
                         "masks [N], [M]")
    sq_x = torch.empty(n, dtype=torch.float32, device=x.device)
    idx_x = torch.empty(n, dtype=torch.int64, device=x.device)
    sq_y = torch.empty(m, dtype=torch.float32, device=x.device)
    idx_y = torch.empty(m, dtype=torch.int64, device=x.device)
    NN_DUAL.launch(x.data_ptr(), y.data_ptr(), xv.data_ptr(), yv.data_ptr(),
                   n, m, sq_x.data_ptr(), idx_x.data_ptr(), sq_y.data_ptr(),
                   idx_y.data_ptr())
    return sq_x, idx_x, sq_y, idx_y


def nn_argmin_dual(x: Tensor, y: Tensor,
                   x_valid: Tensor | None = None,
                   y_valid: Tensor | None = None):
    """Both-direction 1-NN: (sq_x2y [N], idx_x2y [N], sq_y2x [M],
    idx_y2x [M]). Kernel C1 on CUDA tensors, its plain version on CPU
    tensors. ``x_valid``/``y_valid`` mask padded rows out of the search
    in the other direction (True = real point)."""
    tensors = [t for t in (x, y, x_valid, y_valid) if t is not None]
    if on_cpu(*tensors):
        return nn_argmin_dual_plain(x, y, x_valid, y_valid)
    return nn_argmin_dual_cuda(x, y, x_valid, y_valid)
