# Frozen copy of deformationpyramid_tpu_torch/match/backbone.py at commit
# 52465dd567ae528633903efcb67c623d9d527dd1: the einsum (plain) route only, for the
# benchmark's reference; it imports nothing of the port.
"""KPFCN backbone: encoder/decoder built from an architecture string list.

Counterpart of ``deformationpyramid_tpu/match/backbone.py`` (reference
``correspondence/lepard/backbone.py:5-142`` and ``lepard/models.py:3-21``).
The dimension/radius bookkeeping mirrors the reference exactly (skip dims,
doubling per strided layer, simple-block out/2 quirk), so reference
checkpoints map one-to-one.

Structure note: the **plan** (block types, layers, radii, skip indices) is
static and derived from (cfg, architecture) by :func:`kpfcn_plan`; the
**params** tree holds tensors only (the weights, and each KPConv's
``kernel_points`` buffer).

The eval path ('coarse' phase) runs the encoder plus the first
upsample+unary decoder pair and projects to ``coarse_feature_dim`` with a
1x1 conv (``backbone.py:120-142``); deeper decoder blocks exist for the fine
phase and are built but unused at eval, as in the reference.

Input: a ``pyramid`` dict of padded per-level arrays (see ``data/collate``):
  points[l]    [N_l, 3]     stacked src+tgt points (padded)
  valids[l]    [N_l]        validity mask
  neighbors[l] [N_l, K_l]   radius neighbors within level l (shadow = N_l)
  pools[l]     [N_{l+1}, K] level l indices pooled to level l+1
  upsamples[l] [N_l, K]     level l+1 indices for upsampling to level l
  features     [N_0, in_feats_dim]
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from .kpconv import (
    KPConvConfig, apply_resnetb_block, apply_simple_block, apply_unary,
    closest_pool, init_resnetb_block, init_simple_block, init_unary,
    _kaiming_uniform,
)

Tensor = torch.Tensor

KPFCN_ARCHITECTURE = (
    "simple", "resnetb",
    "resnetb_strided", "resnetb", "resnetb",
    "resnetb_strided", "resnetb", "resnetb",
    "resnetb_strided", "resnetb", "resnetb",
    "nearest_upsample", "unary",
    "nearest_upsample", "unary",
    "nearest_upsample", "unary",
)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    type: str          # 'simple' | 'resnetb' | 'unary' | 'nearest_upsample'
    layer: int
    strided: bool
    radius: float
    in_dim: int
    out_dim: int
    # 'deformable' in the block name (reference block_decider checks
    # 'deform' in block_name, blocks.py:566,629); the collate computes the
    # neighbor table at deform_radius for these blocks (dataloader.py:458-483)
    deform: bool = False


@dataclasses.dataclass(frozen=True)
class KPFCNPlan:
    encoder: tuple[BlockPlan, ...]
    decoder: tuple[BlockPlan, ...]
    encoder_skips: tuple[int, ...]
    decoder_concats: tuple[int, ...]
    coarse_in_dim: int     # input dim of the coarse_out 1x1 conv
    fine_in_dim: int


@functools.lru_cache(maxsize=8)
def kpfcn_plan(cfg: KPConvConfig,
               architecture: tuple[str, ...] = KPFCN_ARCHITECTURE) -> KPFCNPlan:
    """Static structure mirroring the reference constructor bookkeeping."""
    layer = 0
    r = cfg.first_subsampling_dl * cfg.conv_radius
    in_dim = cfg.in_feats_dim
    out_dim = cfg.first_feats_dim
    encoder: list[BlockPlan] = []
    encoder_skip_dims: list[int] = []
    encoder_skips: list[int] = []

    for block_i, block in enumerate(architecture):
        if any(t in block for t in ("pool", "strided", "upsample", "global")):
            encoder_skips.append(block_i)
            encoder_skip_dims.append(in_dim)
        if "upsample" in block:
            break
        strided = "strided" in block
        deform = "deformable" in block
        if block.startswith("simple"):
            encoder.append(BlockPlan("simple", layer, strided, r, in_dim,
                                     out_dim, deform))
            in_dim = out_dim // 2
        elif block.startswith("resnetb"):
            encoder.append(BlockPlan("resnetb", layer, strided, r, in_dim,
                                     out_dim, deform))
            in_dim = out_dim
        else:
            raise ValueError(block)
        if "pool" in block or "strided" in block:
            layer += 1
            r *= 2
            out_dim *= 2

    coarse_in_dim = in_dim // 2
    start_i = next(i for i, b in enumerate(architecture) if "upsample" in b)
    decoder: list[BlockPlan] = []
    decoder_concats: list[int] = []
    for block_i, block in enumerate(architecture[start_i:]):
        if block_i > 0 and "upsample" in architecture[start_i + block_i - 1]:
            in_dim += encoder_skip_dims[layer]
            decoder_concats.append(block_i)
        if block == "unary":
            decoder.append(BlockPlan("unary", layer, False, r, in_dim, out_dim))
        elif "upsample" in block:
            decoder.append(BlockPlan("nearest_upsample", layer, False, r,
                                     in_dim, in_dim))
        else:
            raise ValueError(block)
        in_dim = out_dim
        if "upsample" in block:
            layer -= 1
            r *= 0.5
            out_dim = out_dim // 2

    return KPFCNPlan(tuple(encoder), tuple(decoder), tuple(encoder_skips),
                     tuple(decoder_concats), coarse_in_dim, out_dim)


def init_kpfcn(gen: torch.Generator, cfg: KPConvConfig,
               architecture: tuple[str, ...] = KPFCN_ARCHITECTURE) -> dict:
    """Parameter tree (tensors only) following the plan, on the CPU."""
    plan = kpfcn_plan(cfg, tuple(architecture))
    enc = []
    for bp in plan.encoder:
        if bp.type == "simple":
            enc.append(init_simple_block(gen, bp.in_dim, bp.out_dim,
                                         bp.radius, cfg, deformable=bp.deform))
        else:
            enc.append(init_resnetb_block(gen, bp.in_dim, bp.out_dim,
                                          bp.radius, cfg, deformable=bp.deform))
    dec = []
    for bp in plan.decoder:
        if bp.type == "unary":
            dec.append(init_unary(gen, bp.in_dim, bp.out_dim, cfg))
        else:
            dec.append({})
    return {
        "encoder": enc,
        "decoder": dec,
        "coarse_out": {
            "w": _kaiming_uniform(gen,
                                  (plan.coarse_in_dim, cfg.coarse_feature_dim),
                                  plan.coarse_in_dim),
            "b": torch.zeros(cfg.coarse_feature_dim),
        },
        "fine_out": {
            "w": _kaiming_uniform(gen,
                                  (plan.fine_in_dim, cfg.fine_feature_dim),
                                  plan.fine_in_dim),
            "b": torch.zeros(cfg.fine_feature_dim),
        },
    }


def apply_kpfcn_coarse(params: dict, pyramid: dict, cfg: KPConvConfig,
                       architecture: tuple[str, ...] = KPFCN_ARCHITECTURE) -> Tensor:
    """Encoder + first decoder upsample/unary -> coarse features [N_c, C]."""
    plan = kpfcn_plan(cfg, tuple(architecture))
    pts = pyramid["points"]
    valids = pyramid["valids"]
    neighbors = pyramid["neighbors"]
    pools = pyramid["pools"]
    upsamples = pyramid["upsamples"]

    x = pyramid["features"]
    skip_x = []
    for block_i, (bp, p) in enumerate(zip(plan.encoder, params["encoder"])):
        if block_i in plan.encoder_skips:
            skip_x.append(x)
        l = bp.layer
        if bp.strided:
            q_pts, s_pts = pts[l + 1], pts[l]
            neighb = pools[l]
            q_valid, s_valid = valids[l + 1], valids[l]
        else:
            q_pts = s_pts = pts[l]
            neighb = neighbors[l]
            q_valid = s_valid = valids[l]
        if bp.type == "simple":
            x = apply_simple_block(p, x, q_pts, s_pts, neighb, q_valid,
                                   bp.radius, cfg)
        else:
            x = apply_resnetb_block(p, x, q_pts, s_pts, neighb, q_valid,
                                    s_valid, bp.strided, bp.radius, cfg)

    for block_i, (bp, p) in enumerate(zip(plan.decoder[:2], params["decoder"][:2])):
        if block_i in plan.decoder_concats:
            x = torch.cat([x, skip_x.pop()], dim=1)
        l = bp.layer
        if bp.type == "nearest_upsample":
            x = closest_pool(x, upsamples[l - 1])
        else:
            x = apply_unary(p, x, valids[l], cfg)

    return x @ params["coarse_out"]["w"] + params["coarse_out"]["b"]
