"""Weighted rigid fitting (Kabsch / Umeyama) and the embedded-deformation
warp.

Counterpart of ``deformationpyramid_tpu/geometry/kabsch.py``. Reference
parity: ``rigid_fit`` (``model/geometry.py:8-33``, which ships the 3x3 SVDs
to the CPU in double; a batched float32 SVD is accurate at these condition
numbers) and ``ED_warp`` (``model/geometry.py:37-49``). Both are plain
PyTorch: the JAX package runs them outside any kernel too.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def rigid_fit(X: Tensor, Y: Tensor, w: Tensor, eps: float = 1e-4
              ) -> tuple[Tensor, Tensor]:
    """Weighted least-squares rigid transform R, t with R @ X + t ~ Y.

    X, Y: [B, N, 3]; w: [B, N, 1] non-negative confidence weights.
    Returns R [B, 3, 3], t [B, 3, 1]. Reflection is fixed by the sign of
    det(U) det(V) on the smallest singular vector (Umeyama). U and V are
    fixed only up to the SVD's sign conventions, which differ between
    libraries; R and t do not depend on them.
    """
    W1 = torch.sum(torch.abs(w), dim=1, keepdim=True)
    w_norm = w / (W1 + eps)
    mean_X = torch.sum(w_norm * X, dim=1, keepdim=True)
    mean_Y = torch.sum(w_norm * Y, dim=1, keepdim=True)
    Sxy = torch.einsum("bni,bnj->bij", Y - mean_Y, w_norm * (X - mean_X))
    U, _, Vt = torch.linalg.svd(Sxy)
    det = torch.linalg.det(U) * torch.linalg.det(Vt.transpose(-1, -2))
    S = torch.eye(3, dtype=Sxy.dtype, device=Sxy.device).repeat(
        Sxy.shape[0], 1, 1)
    S[:, 2, 2] = det
    R = U @ S @ Vt
    t = mean_Y.transpose(1, 2) - R @ mean_X.transpose(1, 2)
    return R, t


def ed_warp(x: Tensor, g: Tensor, R: Tensor, t: Tensor, w: Tensor) -> Tensor:
    """Embedded-deformation skinning (Sumner 2007).

    x [N, 3] points, per-point K anchors: g [N, K, 3] anchor node positions,
    R [N, K, 3, 3] node rotations, t [N, K, 3] node translations,
    w [N, K] normalized skinning weights. Returns warped [N, 3].
    """
    local = x[:, None] - g                                   # [N, K, 3]
    rotated = torch.einsum("nkij,nkj->nki", R, local)        # [N, K, 3]
    y = (rotated + g + t) * w[..., None]
    return torch.sum(y, dim=1)
