"""Truncated chamfer distance with the L1 point reduction.

Counterpart of ``deformationpyramid_tpu/ops/chamfer.py`` (reference
``model/loss.py:94-258``):

* two-sided 1-NN squared distances;
* truncation compares the squared distance with ``trunc`` and zeroes the
  contribution (and its gradient);
* L1 point reduction: sqrt of the squared NN distance, summed, divided by
  the true point count;
* batch reduction: sum over the batch, divided by the batch size or the
  weight sum.

The argmins come from the non-differentiable dual sweep
(:func:`ops.knn.nn_argmin_dual`, kernel C1 on the card); the loss is then
rebuilt from gathered points, so autograd sees only O(N) work and both the
query and the gathered database points receive gradient.
"""
from __future__ import annotations

import torch

from .knn import nn_argmin_dual

Tensor = torch.Tensor


def _gathered_sum(x: Tensor, y: Tensor, idx: Tensor, x_valid: Tensor | None,
                  trunc: float) -> Tensor:
    """Sum over x of sqrt(||x_i - y[idx_i]||^2), truncated."""
    sq = torch.sum((x - y[idx]) ** 2, dim=-1)
    keep = sq < trunc
    if x_valid is not None:
        keep = keep & x_valid
    # The double where keeps the sqrt gradient finite on dropped entries;
    # the 1e-16 floor guards d == 0 exactly.
    safe = torch.where(keep, torch.clamp_min(sq, 1e-16), 1.0)
    return torch.sum(torch.where(keep, torch.sqrt(safe), 0.0))


def _gathered_normal_sum(x: Tensor, y: Tensor, idx: Tensor,
                         x_normals: Tensor, y_normals: Tensor,
                         x_valid: Tensor | None, trunc: float) -> Tensor:
    """Sum over x of 1 - |cos(n_x, n_y[idx])| on the distance term's
    truncation mask (``loss.py:200-217``)."""
    nn_normals = y_normals[idx]
    sq = torch.sum((x - y[idx]) ** 2, dim=-1)
    keep = sq < trunc
    if x_valid is not None:
        keep = keep & x_valid
    # F.cosine_similarity(eps=1e-6): each norm clamped from below by eps
    nx = torch.clamp_min(torch.linalg.vector_norm(x_normals, dim=-1), 1e-6)
    ny = torch.clamp_min(torch.linalg.vector_norm(nn_normals, dim=-1), 1e-6)
    cos = torch.sum(x_normals * nn_normals, dim=-1) / (nx * ny)
    return torch.sum(torch.where(keep, 1.0 - torch.abs(cos), 0.0))


def truncated_chamfer(x: Tensor, y: Tensor,
                      x_valid: Tensor | None = None,
                      y_valid: Tensor | None = None,
                      x_length: Tensor | float | None = None,
                      y_length: Tensor | float | None = None,
                      trunc: float = 1e9,
                      x_normals: Tensor | None = None,
                      y_normals: Tensor | None = None,
                      return_normals: bool = False):
    """Single-pair truncated chamfer distance (L1 point reduction).

    x: [N, 3], y: [M, 3]; ``x_valid``/``y_valid`` are padding masks (True
    = real point); the means divide by ``x_length``/``y_length`` (default:
    the mask sums, or N/M). With ``return_normals`` also returns the
    two-sided 1 - |cos| normals term, which the reference computes but
    drops (``loss.py:255-258``).
    """
    n, m = x.shape[0], y.shape[0]
    if x_length is None:
        x_length = x_valid.sum() if x_valid is not None else n
    if y_length is None:
        y_length = y_valid.sum() if y_valid is not None else m
    with torch.no_grad():
        _, idx_x, _, idx_y = nn_argmin_dual(x.detach(), y.detach(),
                                            x_valid, y_valid)
    sum_x = _gathered_sum(x, y, idx_x, x_valid, trunc)
    sum_y = _gathered_sum(y, x, idx_y, y_valid, trunc)
    dist = sum_x / x_length + sum_y / y_length
    if not return_normals:
        return dist
    if x_normals is None or y_normals is None:
        raise ValueError("return_normals requires x_normals and y_normals")
    norm_x = _gathered_normal_sum(x, y, idx_x, x_normals, y_normals,
                                  x_valid, trunc)
    norm_y = _gathered_normal_sum(y, x, idx_y, y_normals, x_normals,
                                  y_valid, trunc)
    return dist, norm_x / x_length + norm_y / y_length


def batched_truncated_chamfer(x: Tensor, y: Tensor,
                              x_lengths: Tensor | None = None,
                              y_lengths: Tensor | None = None,
                              weights: Tensor | None = None,
                              trunc: float = 1e9,
                              batch_reduction: str | None = "mean") -> Tensor:
    """Batched version over padded [B, N, 3] / [B, M, 3] clouds with
    lengths, weights and mean/sum/None batch reduction."""
    b, n, _ = x.shape
    m = y.shape[1]
    per_pair = []
    for i in range(b):
        xv = None if x_lengths is None else (
            torch.arange(n, device=x.device) < x_lengths[i])
        yv = None if y_lengths is None else (
            torch.arange(m, device=y.device) < y_lengths[i])
        xl = n if x_lengths is None else x_lengths[i].to(torch.float32)
        yl = m if y_lengths is None else y_lengths[i].to(torch.float32)
        per_pair.append(truncated_chamfer(x[i], y[i], x_valid=xv, y_valid=yv,
                                          x_length=xl, y_length=yl,
                                          trunc=trunc))
    per_pair = torch.stack(per_pair)
    if weights is not None:
        per_pair = per_pair * weights
    if batch_reduction is None:
        return per_pair
    total = torch.sum(per_pair)
    if batch_reduction == "mean":
        total = total / (torch.sum(weights) if weights is not None else b)
    return total
