"""Lepard matcher pipeline: KPFCN -> split -> transformer -> match -> fit.

Counterpart of ``deformationpyramid_tpu/match/pipeline.py`` (reference
``correspondence/lepard/pipeline.py:8-84``). Single-pair; the coarse stacked
features split into padded [S, C]/[T, C] clouds at the static caps
``s_cap``/``t_cap`` by gathers, and the match list has a fixed capacity, so
every output compares row for row with the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..utils import timers
from .backbone import KPFCN_ARCHITECTURE, apply_kpfcn_coarse, init_kpfcn
from .kpconv import KPConvConfig, gather_rows
from .matching import (
    MatchingConfig, confidence_matrix, extract_matches, extract_matches_all,
    init_matching,
)
from .procrustes import ProcrustesConfig, soft_procrustes
from .transformer import TransformerConfig, apply_transformer, init_transformer

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    kpfcn: KPConvConfig = dataclasses.field(default_factory=KPConvConfig)
    transformer: TransformerConfig = dataclasses.field(
        default_factory=TransformerConfig)
    matching: MatchingConfig = dataclasses.field(
        default_factory=MatchingConfig)
    procrustes: ProcrustesConfig = dataclasses.field(
        default_factory=ProcrustesConfig)
    coarse_level: int = 2          # positive index of the coarse level
    # None (default) = uncapped: capacity scales with the coarse cap (all
    # mutual-max matches above thr, reference matching.py:71-88); an int
    # pins a fixed top-k capacity
    max_matches: int | None = None


def init_matcher(gen: torch.Generator, cfg: MatcherConfig) -> dict:
    return {
        "backbone": init_kpfcn(gen, cfg.kpfcn, KPFCN_ARCHITECTURE),
        "transformer": init_transformer(gen, cfg.transformer),
        "matching": init_matching(gen, cfg.matching),
    }


def split_coarse(coarse_feats: Tensor, coarse_pts: Tensor,
                 src_len: Tensor | int, tgt_len: Tensor | int,
                 s_cap: int, t_cap: int):
    """Split stacked [src ; tgt] coarse arrays into padded per-cloud arrays.

    Equivalent of ``Pipeline.split_feats`` (``pipeline.py:55-84``) with
    offset gathers. Padded gather rows index the far/invalid region and are
    masked. ``src_len``/``tgt_len`` may be 0-d tensors on the device; they
    are never read on the host.
    """
    n = coarse_feats.shape[0]
    dev = coarse_feats.device
    s_idx = torch.arange(s_cap, device=dev)
    t_idx = src_len + torch.arange(t_cap, device=dev)
    src_mask = torch.arange(s_cap, device=dev) < src_len
    tgt_mask = torch.arange(t_cap, device=dev) < tgt_len
    s_gather = s_idx.clamp(0, n - 1)
    t_gather = t_idx.clamp(0, n - 1)
    src_feats = torch.where(src_mask[:, None],
                            gather_rows(coarse_feats, s_gather), 0.0)
    tgt_feats = torch.where(tgt_mask[:, None],
                            gather_rows(coarse_feats, t_gather), 0.0)
    s_pcd = torch.where(src_mask[:, None], coarse_pts[s_gather], 0.0)
    t_pcd = torch.where(tgt_mask[:, None], coarse_pts[t_gather], 0.0)
    return src_feats, tgt_feats, s_pcd, t_pcd, src_mask, tgt_mask


def apply_matcher(params: dict, pyramid: dict, src_len_coarse: Tensor | int,
                  tgt_len_coarse: Tensor | int, cfg: MatcherConfig,
                  s_cap: int | None = None, t_cap: int | None = None,
                  gt_rot: Tensor | None = None, gt_trn: Tensor | None = None,
                  gen: torch.Generator | None = None) -> dict[str, Any]:
    """Full matcher forward for one pair.

    ``pyramid`` is the device-side PairPyramid dict
    (``data.collate.pyramid_to_device``); ``src_len_coarse`` /
    ``tgt_len_coarse`` are the true coarse-level counts. Returns the data
    dict (s_pcd, t_pcd, masks, conf matrix, matches, R/t, position_layers,
    vec6d for NeCo).
    """
    coarse_feats = apply_kpfcn_coarse(params["backbone"], pyramid, cfg.kpfcn)
    coarse_pts = pyramid["points"][cfg.coarse_level]
    n_c = coarse_feats.shape[0]
    s_cap = s_cap or n_c
    t_cap = t_cap or n_c

    src_feats, tgt_feats, s_pcd, t_pcd, src_mask, tgt_mask = split_coarse(
        coarse_feats, coarse_pts, src_len_coarse, tgt_len_coarse, s_cap, t_cap)

    src_feats, tgt_feats, src_pe, tgt_pe, position_layers = apply_transformer(
        params["transformer"], src_feats, tgt_feats, s_pcd, t_pcd,
        src_mask, tgt_mask, cfg.transformer,
        gt_rot=gt_rot, gt_trn=gt_trn, gen=gen)

    with timers.span("dp::landmark.matching"):
        conf = confidence_matrix(params["matching"], src_feats, tgt_feats,
                                 src_pe, tgt_pe, src_mask, tgt_mask,
                                 cfg.matching, cfg.transformer.pe_type)
        if cfg.max_matches:
            match_idx, match_conf, match_valid = extract_matches(
                conf, cfg.matching.confidence_threshold, cfg.max_matches)
        else:
            # uncapped: one potential match per src row, reference semantics
            match_idx, match_conf, match_valid = extract_matches_all(
                conf, cfg.matching.confidence_threshold)

    R, t, _, _, condition, ok = soft_procrustes(
        conf, s_pcd, t_pcd, src_mask, tgt_mask, cfg.procrustes)

    # 6D vectors for NeCo (outlier_rejection/pipeline.py:80-113)
    vec6d = torch.cat([s_pcd[match_idx[:, 0]], t_pcd[match_idx[:, 1]]],
                      dim=-1)
    vec6d = torch.where(match_valid[:, None], vec6d, 0.0)

    return {
        "s_pcd": s_pcd, "t_pcd": t_pcd,
        "src_mask": src_mask, "tgt_mask": tgt_mask,
        "src_feats": src_feats, "tgt_feats": tgt_feats,
        "conf_matrix_pred": conf,
        "match_idx": match_idx, "match_conf": match_conf,
        "match_valid": match_valid,
        "R_s2t_pred": R, "t_s2t_pred": t,
        "condition": condition, "solution_mask": ok,
        "position_layers": position_layers,
        "vec_6d": vec6d, "vec_6d_mask": match_valid,
        "vec_6d_ind": match_idx,
    }
