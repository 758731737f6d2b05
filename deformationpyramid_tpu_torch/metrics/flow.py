"""Scene-flow evaluation metrics.

Counterpart of ``deformationpyramid_tpu/metrics/flow.py`` (reference
``scene_flow_metrics`` / ``compute_flow_metrics``,
``model/loss.py:382-471``): EPE3D, AccS, AccR and outlier in percent, on
the full cloud and on visible/occluded splits, with padding masks and a
(sum, count) form for aggregating across pairs or devices.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _masked_mean(x: Tensor, mask: Tensor | None) -> Tensor:
    if mask is None:
        return torch.mean(x)
    return torch.sum(torch.where(mask, x, 0.0)) / torch.clamp_min(mask.sum(), 1)


def scene_flow_metrics(pred: Tensor, labels: Tensor, mask: Tensor | None = None,
                       strict: float = 0.025, relax: float = 0.05
                       ) -> dict[str, Tensor]:
    """pred/labels [N, 3] flows -> EPE3D (x100, cm), AccS, AccR, outlier (%).
    AccS/AccR accept an absolute OR relative error under the threshold;
    outlier is a relative error > 0.3 (``model/loss.py:382-403``)."""
    l2 = torch.sqrt(torch.sum((pred - labels) ** 2, dim=-1))
    lab = torch.sqrt(torch.sum(labels * labels, dim=-1))
    rel = l2 / (lab + 1e-20)
    f32 = torch.float32
    return {
        "epe": _masked_mean(l2, mask) * 100.0,
        "AccS": _masked_mean(((l2 < strict) | (rel < strict)).to(f32), mask) * 100.0,
        "AccR": _masked_mean(((l2 < relax) | (rel < relax)).to(f32), mask) * 100.0,
        "outlier": _masked_mean((rel > 0.3).to(f32), mask) * 100.0,
    }


def compute_flow_metrics(flow: Tensor, flow_gt: Tensor,
                         overlap: Tensor | None = None,
                         valid: Tensor | None = None) -> dict[str, Tensor]:
    """full / visible / occluded metric splits (``model/loss.py:431-471``)."""
    out = {f"full-{k}": v
           for k, v in scene_flow_metrics(flow, flow_gt, valid).items()}
    if overlap is not None:
        vis = overlap if valid is None else (overlap & valid)
        occ = (~overlap) if valid is None else ((~overlap) & valid)
        out.update({f"vis-{k}": v
                    for k, v in scene_flow_metrics(flow, flow_gt, vis).items()})
        out.update({f"occ-{k}": v
                    for k, v in scene_flow_metrics(flow, flow_gt, occ).items()})
    return out


def metric_sums(flow: Tensor, flow_gt: Tensor, mask: Tensor | None = None,
                strict: float = 0.025, relax: float = 0.05
                ) -> dict[str, Tensor]:
    """(sum, count) form of the metrics: add the sums over pairs or devices,
    then divide by the counts."""
    diff = flow - flow_gt
    l2 = torch.sqrt(torch.sum(diff * diff, dim=-1))
    lab = torch.sqrt(torch.sum(flow_gt * flow_gt, dim=-1))
    rel = l2 / (lab + 1e-20)
    if mask is None:
        mask = torch.ones(l2.shape, dtype=torch.bool, device=l2.device)
    w = mask.to(torch.float32)
    return {
        "epe_sum": torch.sum(l2 * w),
        "accS_sum": torch.sum(((l2 < strict) | (rel < strict)) * w),
        "accR_sum": torch.sum(((l2 < relax) | (rel < relax)) * w),
        "outlier_sum": torch.sum((rel > 0.3) * w),
        "count": torch.sum(w),
    }
