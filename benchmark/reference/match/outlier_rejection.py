# Frozen copy of deformationpyramid_tpu_torch/match/outlier_rejection.py at commit
# 52465dd567ae528633903efcb67c623d9d527dd1: the einsum (plain) route only, for the
# benchmark's reference; it imports nothing of the port.
"""NeCo outlier rejection: per-match confidence via compatibility attention.

Counterpart of ``deformationpyramid_tpu/match/outlier_rejection.py``
(reference ``Outlier_Rejection``,
``correspondence/outlier_rejection/pipeline.py:9-119``): matches become 6D
vectors [src_xyz ; tgt_xyz], an optional spatial-consistency matrix
clamp(1 - (d_src - d_tgt)^2 / sigma^2) multiplies the attention logits, N
attention layers refine features, and an MLP+sigmoid emits per-match inlier
confidence. With the compatibility multiplier the attention takes the plain
einsum path, as in the JAX package.

Single-pair convention: vec6d [K, 6] (static padded match count), mask [K].
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .attention import (AttentionConfig, apply_attention_layer,
                        init_attention_layer)
from .position_encoding import VolPEConfig, axis_codes

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class NeCoConfig:
    """Defaults follow ``configs/outlier_rejection.yaml``."""

    in_dim: int = 6
    feature_dim: int = 144
    n_head: int = 8
    num_layers: int = 9
    pe_type: str = "rotary"
    voxel_size: float = 0.08
    sigma_spat: float = 0.1
    spatial_consistency_check: bool = True

    @property
    def attention(self) -> AttentionConfig:
        return AttentionConfig(self.feature_dim, self.n_head, self.pe_type)

    @property
    def vol(self) -> VolPEConfig:
        # NeCo applies the volumetric PE to the 6D vector: feature_dim//6
        # frequencies per axis over 6 axes
        return VolPEConfig(feature_dim=self.feature_dim,
                           voxel_size=self.voxel_size, pe_type=self.pe_type)


def _torch_linear(gen: torch.Generator, fan_in: int, fan_out: int) -> dict:
    bound = 1.0 / math.sqrt(fan_in)
    return {"w": (torch.rand((fan_in, fan_out), generator=gen) * 2.0 - 1.0)
            * bound,
            "b": (torch.rand((fan_out,), generator=gen) * 2.0 - 1.0) * bound}


def init_neco(gen: torch.Generator, cfg: NeCoConfig = NeCoConfig()) -> dict:
    return {
        "in_proj": _torch_linear(gen, cfg.in_dim, cfg.feature_dim),
        "layers": [init_attention_layer(gen, cfg.attention)
                   for _ in range(cfg.num_layers)],
        "cls1": _torch_linear(gen, cfg.feature_dim, 64),
        "cls2": _torch_linear(gen, 64, 32),
        "cls3": _torch_linear(gen, 32, 1),
    }


def _vol_pe_6d(vec6d: Tensor, cfg: NeCoConfig) -> Tensor:
    """NeCo's 6D volumetric PE: the source and target halves each get a
    3-axis encoding at feature_dim//2 and concatenate
    (``outlier_rejection/position_encoding.py:45-55``). That module's
    voxelize has NO volume origin (``:19``), unlike lepard's."""
    vox = vec6d.detach() / cfg.voxel_size
    return axis_codes(vox, cfg.feature_dim // 6, cfg.pe_type)


def _linear(x: Tensor, p: dict) -> Tensor:
    return x @ p["w"] + p["b"]


def apply_neco(params: dict, vec6d: Tensor, mask: Tensor,
               cfg: NeCoConfig = NeCoConfig()) -> Tensor:
    """vec6d [K, 6] padded matches, mask [K] -> confidence [K] in (0, 1)."""
    if cfg.spatial_consistency_check:
        src, tgt = vec6d[:, :3], vec6d[:, 3:]
        d_src = torch.linalg.norm(src[:, None] - src[None], dim=-1)
        d_tgt = torch.linalg.norm(tgt[:, None] - tgt[None], dim=-1)
        compat = (1.0 - (d_src - d_tgt) ** 2 / cfg.sigma_spat ** 2
                  ).clamp_min(0.0).detach()
    else:
        compat = None

    pe = None if cfg.pe_type == "none" else _vol_pe_6d(vec6d, cfg)
    feat = _linear(vec6d, params["in_proj"])
    for lp in params["layers"]:
        feat = apply_attention_layer(lp, feat, feat, pe, pe, mask, mask,
                                     cfg.attention, compatibility=compat)
    h = torch.relu(_linear(feat, params["cls1"]))
    h = torch.relu(_linear(h, params["cls2"]))
    conf = torch.sigmoid(_linear(h, params["cls3"]))[:, 0]
    return conf * mask
