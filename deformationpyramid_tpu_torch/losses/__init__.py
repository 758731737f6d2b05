"""Auxiliary registration losses (reference ``model/loss.py:261-379``).

Counterpart of ``deformationpyramid_tpu/losses/__init__.py``, without the
embedded-deformation graph's ``arap_cost``.
"""
from __future__ import annotations

import torch

from ..ops.chamfer import batched_truncated_chamfer, truncated_chamfer  # noqa: F401

Tensor = torch.Tensor


def landmark_cost(x: Tensor, y: Tensor, valid: Tensor | None = None
                  ) -> Tensor:
    """Mean squared distance between matched landmarks (``loss.py:348-351``)."""
    sq = torch.sum((x - y) ** 2, dim=-1)
    if valid is None:
        return torch.mean(sq)
    return torch.sum(torch.where(valid, sq, 0.0)) \
        / torch.clamp_min(valid.sum(), 1)


def _sym3x3_max_eigval(A: Tensor) -> Tensor:
    """Largest eigenvalue of symmetric [N, 3, 3] matrices, closed form
    (the trigonometric method, Smith 1961): elementwise math only, so it
    differentiates and batches like any other.

    One departure from the JAX package: r is clamped just inside (-1, 1).
    At two equal eigenvalues r is +-1, where arccos has an infinite slope
    and the JAX form's clip a zero one: their product is a NaN gradient
    that Adam never recovers from (it happened within 300 iterations of a
    2000-point solve on the card). Clamped, the slope through r is an
    exact zero there and the rest of the gradient, through q and p, is the
    true one; the value moves by less than 1e-7 of itself."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p1 = a01 ** 2 + a02 ** 2 + a12 ** 2
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-30))
    # det((A - qI)/p) / 2, expanded
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detB = (b00 * (b11 * b22 - b12 ** 2)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detB / 2.0, -1.0 + 1e-6, 1.0 - 1e-6)
    phi = torch.arccos(r) / 3.0
    eig_max = q + 2.0 * p * torch.cos(phi)
    # nearly-spherical case (p2 ~ 0): all eigenvalues equal q
    return torch.where(p2 < 1e-20, q, eig_max)


def nerfies_regularization(jacobian: Tensor, eps: float = 1e-6) -> Tensor:
    """Elastic log-singular-value penalty (``model/loss.py:373-379``).

    jacobian: [N, 3, 3] per-point warp Jacobians. Only the largest singular
    value feeds the loss (``loss.py:377``), so it is the square root of the
    closed-form largest eigenvalue of J^T J: exact, differentiable, and no
    SVD inside the loop.
    """
    JtJ = torch.einsum("nji,njk->nik", jacobian, jacobian)
    sig_max = torch.sqrt(torch.clamp_min(_sym3x3_max_eigval(JtJ), eps ** 2))
    log_max = torch.log(sig_max)
    return torch.mean(log_max ** 2)


def bce_with_zeros_target(p: Tensor, valid: Tensor | None = None) -> Tensor:
    """torch.nn.BCELoss(p, zeros): -mean(log(1-p)) with the -100 clamp."""
    log1mp = torch.clamp_min(torch.log1p(-p), -100.0)
    if valid is None:
        return -torch.mean(log1mp)
    return -torch.sum(torch.where(valid, log1mp, 0.0)) \
        / torch.clamp_min(valid.sum(), 1)
