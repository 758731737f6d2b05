# Frozen copy of deformationpyramid_tpu_torch/match/position_encoding.py at commit
# 52465dd567ae528633903efcb67c623d9d527dd1: the einsum (plain) route only, for the
# benchmark's reference; it imports nothing of the port.
"""Volumetric position encoding (sinusoidal / rotary).

Counterpart of ``deformationpyramid_tpu/match/position_encoding.py``
(reference ``correspondence/lepard/position_encoding.py``). Coordinates
voxelize against a volume origin, then per-axis sin/cos at
``feature_dim//6`` geometric frequencies; 'rotary' packs (cos, sin) pairs
applied RoFormer-style inside attention.

Single-cloud convention: [N, 3] -> sinusoidal [N, C] or rotary [N, C, 2].
"""
from __future__ import annotations

import dataclasses
import math

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class VolPEConfig:
    feature_dim: int = 528
    voxel_size: float = 0.04
    vol_origin: tuple[float, float, float] = (-3.6, -2.4, 1.14)
    pe_type: str = "rotary"   # 'rotary' | 'sinusoidal' | 'none'


def embed_rotary(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """RoFormer rotation: pairs (x_even, x_odd) rotated by (cos, sin); the
    partner of channel 2i is -x[2i+1], of channel 2i+1 it is x[2i]."""
    x2 = torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(x.shape)
    return x * cos + x2 * sin


def embed_pos(pe_type: str, x: Tensor, pe: Tensor) -> Tensor:
    if pe_type == "rotary":
        return embed_rotary(x, pe[..., 0], pe[..., 1])
    if pe_type == "sinusoidal":
        return x + pe
    raise KeyError(pe_type)


def _dup(f: Tensor) -> Tensor:
    """Duplicate each frequency: [N, d] -> [N, 2d] as (f0, f0, f1, f1, ...)."""
    return torch.stack([f, f], dim=-1).reshape(f.shape[:-1] + (-1,))


def axis_codes(vox: Tensor, d_axis: int, pe_type: str) -> Tensor:
    """Voxel coordinates [N, A] -> the code over A axes at ``d_axis // 2``
    frequencies each: sinusoidal [N, A * d_axis] as (sin, cos) per axis, or
    rotary [N, A * d_axis, 2] as (cos, sin) with each frequency twice."""
    div = torch.exp(torch.arange(0, d_axis, 2, dtype=torch.float32,
                                 device=vox.device)
                    * (-math.log(10000.0) / d_axis))
    ang = vox[..., :, None] * div                        # [N, A, d_axis//2]
    sin, cos = torch.sin(ang), torch.cos(ang)
    axes = range(vox.shape[-1])
    if pe_type == "sinusoidal":
        parts = []
        for a in axes:
            parts.extend([sin[..., a, :], cos[..., a, :]])
        return torch.cat(parts, dim=-1)
    if pe_type == "rotary":
        sin_pos = torch.cat([_dup(sin[..., a, :]) for a in axes], dim=-1)
        cos_pos = torch.cat([_dup(cos[..., a, :]) for a in axes], dim=-1)
        return torch.stack([cos_pos, sin_pos], dim=-1)
    raise KeyError(pe_type)


def volumetric_pe(xyz: Tensor, cfg: VolPEConfig) -> Tensor:
    """[N, 3] -> position code; detached (reference ``:82-84``)."""
    xyz = xyz.detach()
    origin = torch.tensor(cfg.vol_origin, dtype=xyz.dtype, device=xyz.device)
    vox = (xyz - origin) / cfg.voxel_size
    return axis_codes(vox, cfg.feature_dim // 3, cfg.pe_type)
