"""Matcher evaluation metrics: Inlier Ratio and NRFMR.

Counterpart of ``deformationpyramid_tpu/metrics/matching.py``. Reference
parity: IR (``outlier_rejection/loss.py:30-60,162-190``) and NRFMR —
non-rigid feature matching recall — (``correspondence/lib/tester.py:35-95``):
for each GT-correspondence source point, blend the flow predicted by the k
nearest matched source landmarks (inverse-distance weights) and count it
recalled if the blended flow lands within ``recall_thr`` of the GT.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def inlier_ratio(ldmk_s: Tensor, ldmk_t: Tensor, valid: Tensor,
                 gt_rot: Tensor, gt_trn: Tensor, s2t_flow_at_ldmk: Tensor,
                 thr: float = 0.04) -> Tensor:
    """Fraction of landmark pairs within thr of the GT-warped source."""
    warped = (gt_rot @ (ldmk_s + s2t_flow_at_ldmk).T + gt_trn).T
    d2 = ((warped - ldmk_t) ** 2).sum(dim=1)
    ok = (d2 < thr ** 2) & valid
    return ok.sum() / valid.sum().clamp_min(1)


def nrfmr(ldmk_s: Tensor, ldmk_t: Tensor, ldmk_valid: Tensor,
          metric_pts: Tensor, metric_flow_gt: Tensor,
          knn: int = 3, recall_thr: float = 0.04,
          search_radius: float = 0.1,
          metric_valid: Tensor | None = None) -> Tensor:
    """Non-rigid feature matching recall over metric points.

    ldmk_s/ldmk_t [K, 3] padded matched landmarks; metric_pts [M, 3] GT
    sample points on the source; metric_flow_gt [M, 3] their GT flow.
    Predicted flow at each metric point = IDW blend of the k nearest
    landmarks' flows (``lib/tester.py:12-33`` blend_anchor_motion), with the
    reference's ``search_radius`` gating: anchors farther than the radius
    get their (euclidean) distance pushed to 1e10 BEFORE inverse-distance
    weighting, so a far landmark contributes ~0 weight — unless ALL k
    anchors are out of radius, in which case the weights degenerate to
    uniform 1/k (that quirk is load-bearing: ``compute_nrfmr`` ignores the
    returned valid_mask, ``lib/tester.py:66-95``, so out-of-range points
    still count in the recall denominator with the uniform blend).

    ``metric_valid`` [M] (optional) marks padding rows to ignore; the
    recall denominator becomes the count of REAL metric points.
    """
    ldmk_flow = ldmk_t - ldmk_s
    d2 = ((metric_pts[:, None] - ldmk_s[None]) ** 2).sum(dim=-1)
    d2 = torch.where(ldmk_valid[None, :], d2, 1e9)
    # a stable sort, not topk: with fewer than ``knn`` valid landmarks the
    # rest tie at 1e9, and the lowest indices must win as in jax.lax.top_k
    near_d2, idx = torch.sort(d2, dim=1, stable=True)
    near_d2, idx = near_d2[:, :knn], idx[:, :knn]
    # clamp-then-gate, matching blend_anchor_motion's order
    # (dists<1e-10 -> 1e-10; dists>search_radius -> 1e10)
    dist = torch.sqrt(near_d2.clamp_min(0.0)).clamp_min(1e-10)
    dist = torch.where(dist > search_radius, 1e10, dist)
    w = 1.0 / dist
    w = w / w.sum(dim=1, keepdim=True)
    flow_pred = (ldmk_flow[idx] * w[..., None]).sum(dim=1)
    err = torch.linalg.norm(flow_pred - metric_flow_gt, dim=1)
    any_ldmk = ldmk_valid.sum() > 0
    ok = (err < recall_thr).to(torch.float32)
    if metric_valid is None:
        recall = ok.mean()
    else:
        mv = metric_valid.to(torch.float32)
        recall = (ok * mv).sum() / mv.sum().clamp_min(1.0)
    return torch.where(any_ldmk, recall, torch.zeros_like(recall))
