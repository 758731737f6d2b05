"""Landmark model: matcher + outlier rejection -> landmark pairs for LNDP.

Counterpart of ``deformationpyramid_tpu/match/landmark.py`` (reference
``Landmark_Model``, ``correspondence/landmark_estimator.py:14-75``): run the
Lepard matcher, score matches with NeCo, threshold-filter the 6D vectors
into (ldmk_s, ldmk_t). The landmark set keeps the matcher's capacity with a
validity mask (invalid rows are zeroed), which feeds straight into the
landmark-mode registration solver (``solve.registration.register_pair``).

Inference runs under ``torch.no_grad()``; the trainers call
``apply_matcher`` / ``apply_neco`` themselves, on a parameter tree that
:func:`trainable` marked.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models.pyramid import tree_map
from ..utils import timers
from .outlier_rejection import NeCoConfig, apply_neco, init_neco
from .pipeline import MatcherConfig, apply_matcher, init_matcher

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LandmarkConfig:
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    neco: NeCoConfig = dataclasses.field(default_factory=NeCoConfig)
    inlier_thr: float = 0.3        # config/LNDP.yaml inlier_thr
    reject_outliers: bool = True


def init_landmark_model(gen: torch.Generator, cfg: LandmarkConfig,
                        device: torch.device | str | None = None) -> dict:
    """Weights drawn from a CPU generator (one seed gives the same weights
    on every device), then moved to ``device``: the GPU unless the caller
    names another."""
    device = torch.device("cuda" if device is None else device)
    params = {"matcher": init_matcher(gen, cfg.matcher),
              "neco": init_neco(gen, cfg.neco)}
    return tree_map(lambda t: t.to(device), params)


def trainable(params: Any) -> Any:
    """The same values as new leaf tensors that require a gradient (they
    share storage with ``params``, which stays as it was): what a training
    step differentiates with respect to."""
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


@torch.no_grad()
def matcher_inference(params: dict, pyramid: dict,
                      src_len_coarse: Tensor | int,
                      tgt_len_coarse: Tensor | int, cfg: LandmarkConfig,
                      s_cap: int | None = None,
                      t_cap: int | None = None) -> dict[str, Any]:
    """Matcher half of :func:`landmark_inference` (Lepard forward +
    mutual-max match extraction -> vec_6d rows), split out so that a caller
    can time matcher and NeCo separately."""
    return apply_matcher(params["matcher"], pyramid, src_len_coarse,
                         tgt_len_coarse, cfg.matcher,
                         s_cap=s_cap, t_cap=t_cap)


@torch.no_grad()
def neco_filter(params: dict, data: dict[str, Any],
                cfg: LandmarkConfig) -> dict[str, Any]:
    """NeCo half: per-match confidence + threshold filter into the padded
    (ldmk_s, ldmk_t, ldmk_valid) landmark set (reference
    ``landmark_estimator.py:63-72``)."""
    with timers.span("dp::landmark.neco"):
        confidence = apply_neco(params["neco"], data["vec_6d"],
                                data["vec_6d_mask"], cfg.neco)
        keep = data["vec_6d_mask"]
        if cfg.reject_outliers:
            keep = keep & (confidence > cfg.inlier_thr)
        vec6d = torch.where(keep[:, None], data["vec_6d"], 0.0)
    return dict(data,
                neco_confidence=confidence,
                ldmk_s=vec6d[:, :3],
                ldmk_t=vec6d[:, 3:],
                ldmk_valid=keep)


def landmark_inference(params: dict, pyramid: dict,
                       src_len_coarse: Tensor | int,
                       tgt_len_coarse: Tensor | int, cfg: LandmarkConfig,
                       s_cap: int | None = None,
                       t_cap: int | None = None) -> dict[str, Any]:
    """Returns dict with ldmk_s/ldmk_t [K, 3], ldmk_valid [K], plus the
    matcher data for diagnostics.

    ``s_cap``/``t_cap`` are static per-cloud coarse caps: without them both
    clouds pad to the FULL stacked coarse size, quadrupling the
    transformer/matching/procrustes work (the [S, T] objects are the
    matcher's cost).
    """
    with timers.span("dp::landmark"):
        data = matcher_inference(params, pyramid, src_len_coarse,
                                 tgt_len_coarse, cfg, s_cap=s_cap,
                                 t_cap=t_cap)
        return neco_filter(params, data, cfg)
