"""Repositioning transformer: interleaved self/cross/positioning layers.

Counterpart of ``deformationpyramid_tpu/match/transformer.py`` (reference
``RepositioningTransformer``,
``correspondence/lepard/transformer.py:100-281``). The 'positioning' layer
runs an inner Matching + SoftProcrustes and re-centers the source position
encoding by the predicted rigid fit — the architecture's signature trick.
Single-pair convention.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..geometry.rotations import euler_to_SO3
from .attention import (AttentionConfig, apply_attention_layer,
                        init_attention_layer)
from .matching import MatchingConfig, confidence_matrix, init_matching
from .position_encoding import VolPEConfig, volumetric_pe
from .procrustes import ProcrustesConfig, soft_procrustes

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    feature_dim: int = 528
    n_head: int = 4
    layer_types: tuple[str, ...] = ("self", "cross", "positioning", "self",
                                    "cross")
    positioning_type: str = "procrustes"   # | 'oracle' | 'randSO3'
    pe_type: str = "rotary"
    vol: VolPEConfig = dataclasses.field(default_factory=VolPEConfig)
    matching: MatchingConfig = dataclasses.field(
        default_factory=MatchingConfig)
    procrustes: ProcrustesConfig = dataclasses.field(
        default_factory=ProcrustesConfig)
    compute_dtype: str = "float32"  # 'bfloat16' = bf16-operand inference
    attention_impl: str = "xla"     # 'flash' = kernel C7, streamed attention

    @property
    def attention(self) -> AttentionConfig:
        return AttentionConfig(self.feature_dim, self.n_head, self.pe_type,
                               compute_dtype=self.compute_dtype,
                               attention_impl=self.attention_impl)


def init_transformer(gen: torch.Generator, cfg: TransformerConfig) -> dict:
    """Params are a list aligned with cfg.layer_types (static structure lives
    in the config, tensors only in the tree)."""
    layers = []
    for l_type in cfg.layer_types:
        if l_type in ("self", "cross"):
            layers.append(init_attention_layer(gen, cfg.attention))
        elif l_type == "positioning":
            if cfg.positioning_type == "procrustes":
                layers.append(init_matching(gen, cfg.matching))
            else:
                layers.append({})
        else:
            raise KeyError(l_type)
    return {"layers": layers}


def randSO3(gen: torch.Generator, dtype=torch.float32,
            device: torch.device | str | None = None) -> Tensor:
    """A random rotation from uniform zyx euler angles in [0, 2 pi)."""
    angles = (torch.rand(3, generator=gen, dtype=dtype) * 2.0 * math.pi
              ).to(device)
    # scipy's extrinsic 'zyx' (az, ay, ax) == Rx(ax) @ Ry(ay) @ Rz(az)
    return euler_to_SO3(angles.flip(0), "XYZ")


def rand_rot_pcd(gen: torch.Generator, pcd: Tensor, mask: Tensor,
                 rot: Tensor | None = None) -> Tensor:
    """Rotate a masked cloud by a random SO(3) about its masked centroid.

    Train-time positioning ablation; reference ``rand_rot_pcd``
    (``transformer.py:259-276``): invalid rows zeroed, centroid over valid
    rows only. ``rot`` overrides the draw (the parity tests hand both
    packages one rotation).
    """
    pcd = torch.where(mask[:, None], pcd, 0.0)
    n_valid = mask.sum().clamp_min(1)
    centroid = pcd.sum(dim=0) / n_valid
    if rot is None:
        rot = randSO3(gen, pcd.dtype, pcd.device)
    return (pcd - centroid) @ rot.T + centroid


def apply_transformer(params: dict, src_feat: Tensor, tgt_feat: Tensor,
                      s_pcd: Tensor, t_pcd: Tensor,
                      src_mask: Tensor, tgt_mask: Tensor,
                      cfg: TransformerConfig,
                      gt_rot: Tensor | None = None,
                      gt_trn: Tensor | None = None,
                      gen: torch.Generator | None = None):
    """Returns (src_feat, tgt_feat, src_pe, tgt_pe, position_layers).

    position_layers collects per-positioning-layer (conf_matrix, R, t,
    condition, ok) for the training loss (``transformer.py:185-205``).
    """
    acfg = cfg.attention
    src_pe = volumetric_pe(s_pcd, cfg.vol)
    tgt_pe = volumetric_pe(t_pcd, cfg.vol)
    position_layers: list[dict[str, Any]] = []

    for l_type, layer in zip(cfg.layer_types, params["layers"]):
        if l_type == "self":
            src_feat = apply_attention_layer(
                layer, src_feat, src_feat, src_pe, src_pe, src_mask,
                src_mask, acfg)
            tgt_feat = apply_attention_layer(
                layer, tgt_feat, tgt_feat, tgt_pe, tgt_pe, tgt_mask,
                tgt_mask, acfg)
        elif l_type == "cross":
            src_feat_new = apply_attention_layer(
                layer, src_feat, tgt_feat, src_pe, tgt_pe, src_mask,
                tgt_mask, acfg)
            # reference updates src first, then tgt attends the UPDATED src
            # (transformer.py:181-182)
            tgt_feat = apply_attention_layer(
                layer, tgt_feat, src_feat_new, tgt_pe, src_pe, tgt_mask,
                src_mask, acfg)
            src_feat = src_feat_new
        elif l_type == "positioning":
            if cfg.positioning_type == "procrustes":
                conf = confidence_matrix(layer, src_feat, tgt_feat,
                                         src_pe, tgt_pe, src_mask, tgt_mask,
                                         cfg.matching, cfg.pe_type)
                R, t, R_fwd, t_fwd, condition, ok = soft_procrustes(
                    conf, s_pcd, t_pcd, src_mask, tgt_mask, cfg.procrustes)
                position_layers.append({"conf_matrix": conf, "R_s2t_pred": R,
                                        "t_s2t_pred": t,
                                        "condition": condition,
                                        "solution_mask": ok})
                src_wrapped = (R_fwd @ s_pcd.T + t_fwd).T
                src_pe = volumetric_pe(src_wrapped, cfg.vol)
                tgt_pe = volumetric_pe(t_pcd, cfg.vol)
            elif cfg.positioning_type == "oracle":
                src_wrapped = (gt_rot @ s_pcd.T + gt_trn).T
                src_pe = volumetric_pe(src_wrapped, cfg.vol)
            elif cfg.positioning_type == "randSO3":
                if gen is None:
                    raise ValueError("randSO3 positioning needs a generator")
                src_wrapped = rand_rot_pcd(gen, s_pcd, src_mask)
                src_pe = volumetric_pe(src_wrapped, cfg.vol)
            else:
                raise KeyError(cfg.positioning_type)
        else:
            raise KeyError(l_type)

    return src_feat, tgt_feat, src_pe, tgt_pe, position_layers
