# Frozen copy of deformationpyramid_tpu_torch/match/losses.py at commit
# 52465dd567ae528633903efcb67c623d9d527dd1: the einsum (plain) route only, for the
# benchmark's reference; it imports nothing of the port.
"""Training losses for the correspondence stack.

Counterpart of ``deformationpyramid_tpu/match/losses.py``:

* ``MatchMotionLoss`` (reference ``correspondence/lepard/loss.py:70-188``):
  focal loss on the confidence matrix against GT mutual-NN matches + L1
  rigid-motion loss on overlap points, applied to the final matrix and every
  positioning layer.
* ``NeCoLoss`` (``outlier_rejection/loss.py:7-190``): class-balanced BCE on
  per-match inlier confidence; the inlier label comes from the GT flow+pose.

Single-pair convention with masks. Nothing here reads a value on the host.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MatchLossConfig:
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    pos_weight: float = 1.0
    neg_weight: float = 1.0
    match_weight: float = 1.0
    motion_weight: float = 1.0
    match_type: str = "dual_softmax"


def _count(mask: Tensor) -> Tensor:
    """Number of set entries as float32, at least 1."""
    return mask.sum().clamp_min(1).to(torch.float32)


def matches_to_conf_gt(match_gt: Tensor, match_gt_valid: Tensor,
                       s: int, t: int) -> Tensor:
    """GT match list [M, 2] (+valid) -> dense 0/1 matrix [S, T]. Padded rows
    of the list land in an extra row and column that are sliced away."""
    conf_gt = torch.zeros((s + 1, t + 1), dtype=torch.float32,
                          device=match_gt.device)
    rows = torch.where(match_gt_valid, match_gt[:, 0], s)
    cols = torch.where(match_gt_valid, match_gt[:, 1], t)
    # an index beyond the matrix is dropped, like a padded row
    inside = (rows < s) & (cols < t)
    rows = torch.where(inside, rows, s)
    cols = torch.where(inside, cols, t)
    conf_gt[rows, cols] = 1.0
    return conf_gt[:s, :t]


def focal_correspondence_loss(conf: Tensor, conf_gt: Tensor, weight: Tensor,
                              cfg: MatchLossConfig) -> Tensor:
    """Dual-softmax focal loss (``lepard/loss.py:190-238`` semantics)."""
    conf = conf.clamp(1e-6, 1.0 - 1e-6)
    alpha, gamma = cfg.focal_alpha, cfg.focal_gamma
    pos = (conf_gt == 1.0) & (weight > 0)
    neg = (conf_gt == 0.0) & (weight > 0)
    loss_pos = -alpha * (1.0 - conf) ** gamma * torch.log(conf)
    loss_neg = -alpha * conf ** gamma * torch.log(1.0 - conf)
    lp = torch.where(pos, loss_pos * weight, 0.0).sum() / _count(pos)
    ln = torch.where(neg, loss_neg * weight, 0.0).sum() / _count(neg)
    return cfg.pos_weight * lp + cfg.neg_weight * ln


def match_recall_precision(conf_gt: Tensor, match_idx: Tensor,
                           match_valid: Tensor) -> tuple[Tensor, Tensor]:
    """Recall/precision of extracted matches vs GT matrix
    (``lepard/loss.py:139-157`` area)."""
    hits = (conf_gt[match_idx[:, 0], match_idx[:, 1]] * match_valid).sum()
    n_pred = _count(match_valid)
    n_gt = conf_gt.sum().clamp_min(1.0)
    return hits / n_gt, hits / n_pred


def match_motion_loss(data: dict, match_gt: Tensor, match_gt_valid: Tensor,
                      coarse_flow: Tensor, gt_rot: Tensor, gt_trn: Tensor,
                      cfg: MatchLossConfig = MatchLossConfig()
                      ) -> tuple[Tensor, dict]:
    """Full matcher loss over the final + positioning-layer conf matrices.

    data: output of ``apply_matcher``; coarse_flow [S, 3] GT flow at coarse
    level; gt_rot/gt_trn the GT rigid motion (R(Ps+flow)+t = Pt).
    """
    s_pcd = data["s_pcd"]
    src_mask, tgt_mask = data["src_mask"], data["tgt_mask"]
    s, t = data["conf_matrix_pred"].shape
    conf_gt = matches_to_conf_gt(match_gt, match_gt_valid, s, t)
    weight = (src_mask[:, None] & tgt_mask[None, :]).to(torch.float32)

    overlap = torch.zeros(s + 1, dtype=torch.bool, device=s_pcd.device)
    overlap[torch.where(match_gt_valid, match_gt[:, 0], s).clamp_max(s)] = True
    overlap = overlap[:s]

    info = {}
    loss = torch.zeros((), dtype=torch.float32, device=s_pcd.device)
    matrices = [data["conf_matrix_pred"]] + [
        pl["conf_matrix"] for pl in data["position_layers"]]
    rigid_preds = [(data["R_s2t_pred"], data["t_s2t_pred"])] + [
        (pl["R_s2t_pred"], pl["t_s2t_pred"])
        for pl in data["position_layers"]]

    recall, precision = match_recall_precision(conf_gt, data["match_idx"],
                                               data["match_valid"])
    info.update({"recall_coarse": recall, "precision_coarse": precision})

    spcd_deformed = s_pcd + coarse_flow
    src_wrapped_gt = (gt_rot @ spcd_deformed.T + gt_trn).T
    sflow_gt = src_wrapped_gt - s_pcd

    for conf, (R_pred, t_pred) in zip(matrices, rigid_preds):
        focal = focal_correspondence_loss(conf, conf_gt, weight, cfg)
        loss = loss + cfg.match_weight * focal
        if cfg.motion_weight > 0:
            src_wrapped_pred = (R_pred @ s_pcd.T + t_pred).T
            sflow_pred = src_wrapped_pred - s_pcd
            e1 = (sflow_pred - sflow_gt).abs().sum(dim=1)
            l1 = torch.where(overlap, e1, 0.0).sum() / _count(overlap)
            # gated on usable recall in the reference (loss.py:110); a where,
            # as in the JAX package: a NaN in the unselected branch still
            # reaches the gradient, and the trainers' guard skips that step
            loss = loss + torch.where(recall > 0.01, cfg.motion_weight * l1,
                                      0.0)
    info["focal_total"] = loss
    return loss, info


# ---------------------------------------------------------------------------
# NeCo loss
# ---------------------------------------------------------------------------

def compute_inlier_mask(vec6d: Tensor, vec6d_valid: Tensor, match_idx: Tensor,
                        s_pcd: Tensor, coarse_flow: Tensor, gt_rot: Tensor,
                        gt_trn: Tensor, inlier_thr: float = 0.04) -> Tensor:
    """GT inlier labels for extracted matches
    (``outlier_rejection/loss.py:162-190``); the reference trains with
    ``inlier_thr: 0.04`` (``configs/train/4dmatch.yaml:28``), the same
    4 cm the IR/NRFMR evaluators use (``lib/tester.py:129``)."""
    s_warp = (gt_rot @ (s_pcd + coarse_flow).T + gt_trn).T
    s_gt = s_warp[match_idx[:, 0]]
    t_matched = vec6d[:, 3:]
    inlier = ((s_gt - t_matched) ** 2).sum(dim=1) < inlier_thr ** 2
    return inlier & vec6d_valid


def balanced_bce(prediction: Tensor, labels: Tensor, valid: Tensor) -> Tensor:
    """Class-balanced BCE (``outlier_rejection/loss.py:69-82``):
    positives weighted by the negative rate and vice versa."""
    p = prediction.clamp(1e-7, 1.0 - 1e-7)
    gt = labels.to(torch.float32)
    bce = -(gt * torch.log(p) + (1.0 - gt) * torch.log(1.0 - p))
    n = _count(valid)
    pos_rate = torch.where(valid, gt, 0.0).sum() / n
    weights = torch.where(gt >= 0.5, 1.0 - pos_rate, pos_rate)
    return torch.where(valid, weights * bce, 0.0).sum() / n


def neco_loss(confidence: Tensor, vec6d: Tensor, vec6d_valid: Tensor,
              match_idx: Tensor, s_pcd: Tensor, coarse_flow: Tensor,
              gt_rot: Tensor, gt_trn: Tensor,
              inlier_thr: float = 0.04) -> tuple[Tensor, dict]:
    """Balanced BCE + IR metrics before/after filtering.

    ``inlier_thr`` is the LABEL threshold (4 cm, reference
    ``configs/train/4dmatch.yaml:28``), distinct from the eval-time
    CONFIDENCE threshold ``config/LNDP.yaml inlier_thr: 0.3``."""
    labels = compute_inlier_mask(vec6d, vec6d_valid, match_idx, s_pcd,
                                 coarse_flow, gt_rot, gt_trn, inlier_thr)
    loss = balanced_bce(confidence, labels, vec6d_valid)
    n = _count(vec6d_valid)
    ir_before = labels.sum() / n
    kept = vec6d_valid & (confidence > 0.5)
    ir_after = (labels & kept).sum() / _count(kept)
    return loss, {"IR_lepard": ir_before, "IR_neco": ir_after,
                  "n_matches": n}
