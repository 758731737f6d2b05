# Frozen copy of deformationpyramid_tpu_torch/match/procrustes.py at commit
# 52465dd567ae528633903efcb67c623d9d527dd1: the einsum (plain) route only, for the
# benchmark's reference; it imports nothing of the port.
"""Soft Procrustes: confidence-weighted rigid fit from a match matrix.

Counterpart of ``deformationpyramid_tpu/match/procrustes.py`` (reference
``SoftProcrustesLayer``, ``correspondence/lepard/procrustes.py:10-93``):
take the globally top-scoring entries of the confidence matrix, weight-fit
a rigid transform (Kabsch), and gate unreliable solutions by SVD condition
number. Single-pair convention; the sample count is the static padded max
(extra entries carry zero weight — numerically identical to the
reference's dynamic count).
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ProcrustesConfig:
    sample_rate: float = 1.0
    max_condition_num: float = 40.0
    # The JAX package's 'approx' is ``jax.lax.approx_max_k``, which has no
    # PyTorch counterpart: the port takes ``torch.topk`` (exact) for both
    # values. The fields stay so that the same yaml files load.
    topk_method: str = "approx"
    approx_recall_target: float = 0.95


def weighted_procrustes_with_condition(X: Tensor, Y: Tensor, w: Tensor,
                                       eps: float = 1e-4):
    """[N,3],[N,3],[N,1] -> (R, t, condition). f32 3x3 SVD on the tensors'
    device (``torch.linalg.svd``, a library call outside any kernel). U and
    V may differ from another library's by paired signs; R, t and the
    condition number do not. A non-finite input gives NaN outputs, as
    ``jnp.linalg.svd`` does (``torch.linalg.svd`` would raise, and a
    training step with a NaN in it must reach the gradient guard)."""
    W1 = w.abs().sum(dim=0, keepdim=True)
    w_norm = w / (W1 + eps)
    mean_X = (w_norm * X).sum(dim=0, keepdim=True)
    mean_Y = (w_norm * Y).sum(dim=0, keepdim=True)
    Sxy = (Y - mean_Y).T @ (w_norm * (X - mean_X))
    finite = torch.isfinite(Sxy).all()
    U, D, Vt = torch.linalg.svd(torch.where(finite, Sxy, 0.0))
    nan = torch.full((), torch.nan, dtype=Sxy.dtype, device=Sxy.device)
    U, D = torch.where(finite, U, nan), torch.where(finite, D, nan)
    condition = D.max() / D.min().clamp_min(1e-12)
    det = torch.linalg.det(U) * torch.linalg.det(Vt.T)
    S = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det),
                                det]))
    R = U @ S @ Vt
    t = mean_Y.T - R @ mean_X.T
    return R, t, condition


def soft_procrustes(conf: Tensor, src_pcd: Tensor, tgt_pcd: Tensor,
                    src_mask: Tensor, tgt_mask: Tensor,
                    cfg: ProcrustesConfig = ProcrustesConfig()):
    """conf [S, T], clouds [S,3]/[T,3] -> (R, t, R_fwd, t_fwd, condition, ok).

    R_fwd/t_fwd are identity-gated by the condition check
    (``procrustes.py:86-91``) and feed the repositioned PE; R/t raw feed the
    loss. The top-k is ``torch.topk`` whatever ``cfg.topk_method`` says (see
    :class:`ProcrustesConfig`); exact ties may come in another order than
    ``jax.lax.top_k``'s, which the weighted fit does not see. Everything
    stays on the device: the gates are ``torch.where``, no host branch.
    """
    s, t_len = conf.shape
    src_len = src_mask.sum()
    tgt_len = tgt_mask.sum()
    entry_max = (torch.maximum(src_len, tgt_len)
                 * cfg.sample_rate).to(torch.int32)
    k = min(max(s, t_len), s * t_len)   # static sample cap

    w, idx = torch.topk(conf.reshape(-1), k)
    idx_src = idx // t_len
    idx_tgt = idx % t_len
    X = src_pcd[idx_src]
    Y = tgt_pcd[idx_tgt]
    pos = torch.arange(k, device=conf.device)
    w = torch.where(pos < entry_max, w, 0.0)

    R, t, condition = weighted_procrustes_with_condition(X, Y, w[:, None])
    ok = (condition < cfg.max_condition_num) & torch.isfinite(condition)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    zero = torch.zeros((3, 1), dtype=R.dtype, device=R.device)
    # NaN guard replaces the reference's try/except identity fallback
    R = torch.where(torch.isfinite(R).all(), R, eye)
    t = torch.where(torch.isfinite(t).all(), t, zero)
    R_fwd = torch.where(ok, R, eye)
    t_fwd = torch.where(ok, t, zero)
    return R, t, R_fwd, t_fwd, condition, ok
