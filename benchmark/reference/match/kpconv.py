# Frozen copy of deformationpyramid_tpu_torch/match/kpconv.py at commit
# 52465dd567ae528633903efcb67c623d9d527dd1: the einsum (plain) route only, for the
# benchmark's reference; it imports nothing of the port.
"""Kernel Point Convolution and network blocks, functional PyTorch.

Counterpart of ``deformationpyramid_tpu/match/kpconv.py`` (reference
``correspondence/lepard/blocks.py``):

* flat stacked clouds [N, ...] with padded shapes; the shadow point is the
  appended row at index N (reference appends a 1e6-offset row,
  ``blocks.py:269``), so host-built neighbor tables use N for "no neighbor",
* the kernel-influence aggregation is two matrix products
  ([K_p, K_n] @ [K_n, C_in] then contraction with [K_p, C_in, C_out]),
* BatchNormBlock is InstanceNorm over the stacked cloud in the reference
  (``blocks.py:443-445``); here a masked per-channel normalization over
  valid rows (population statistics, no affine, eps 1e-5).

All blocks are (init_fn -> params, apply_fn(params, x, level_data)) pairs.
Parameters are nested dicts of tensors; ``kernel_points`` is a buffer, not
a trainable weight.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .kernel_points import kernel_dispositions

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class KPConvConfig:
    """kpfcn_config subset (``configs/lepard.yaml:5-28``)."""

    num_kernel_points: int = 15
    in_points_dim: int = 3
    KP_extent: float = 2.0          # relative to subsampling dl
    conv_radius: float = 2.5
    deform_radius: float = 5.0
    modulated: bool = False         # deformable: per-KP modulation scalars
    KP_influence: str = "linear"
    aggregation_mode: str = "sum"
    fixed_kernel_points: str = "center"
    use_batch_norm: bool = True
    batch_norm_momentum: float = 0.02
    first_subsampling_dl: float = 0.01
    first_feats_dim: int = 256
    in_feats_dim: int = 1
    coarse_feature_dim: int = 528
    fine_feature_dim: int = 264
    coarse_level: int = -2


def _kaiming_uniform(gen: torch.Generator, shape: tuple[int, ...],
                     fan_in: int) -> Tensor:
    # torch kaiming_uniform_(a=sqrt(5)) ==> bound = 1/sqrt(fan_in)
    bound = 1.0 / math.sqrt(fan_in)
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def init_kpconv(gen: torch.Generator, in_ch: int, out_ch: int, radius: float,
                cfg: KPConvConfig, deformable: bool = False) -> dict:
    """Params hold the trainable weights plus the kernel-point disposition
    as a non-trainable float buffer, as the reference's per-module
    ``kernel_points`` buffers.

    With ``deformable`` (reference ``blocks.py:179-193``) the tree gains a
    nested rigid ``offset_conv`` predicting per-point kernel offsets (+
    modulation scalars when ``cfg.modulated``) and a zero-init
    ``offset_bias``."""
    k = cfg.num_kernel_points
    p = {
        "weights": _kaiming_uniform(gen, (k, in_ch, out_ch), in_ch * k),
        "kernel_points": torch.from_numpy(kernel_dispositions(
            k, cfg.in_points_dim, cfg.fixed_kernel_points, radius).copy()),
    }
    if deformable:
        offset_dim = (cfg.in_points_dim + (1 if cfg.modulated else 0)) * k
        p["offset_conv"] = init_kpconv(gen, in_ch, offset_dim, radius, cfg)
        p["offset_bias"] = torch.zeros(offset_dim)
    return p


def _pad_row(x: Tensor, value: float) -> Tensor:
    """Append the shadow row."""
    return torch.cat([x, x.new_full((1, x.shape[1]), value)], dim=0)


def gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """``x[idx]`` for x [N, C] and integer idx [...] -> [..., C], through
    ``index_select``: the same values, but its backward is an
    ``index_add_`` where advanced indexing's is a sort-based accumulate that
    walks the copies of one index one after the other. The neighbour tables
    name the shadow row up to half the time, and at the training shapes that
    backward alone took 34 ms a gather on an H100, 70% of a matcher step.
    On CUDA ``index_add_`` sums with atomics, in no fixed order."""
    return torch.index_select(x, 0, idx.reshape(-1)).reshape(
        *idx.shape, *x.shape[1:])


def apply_kpconv(p: dict, q_pts: Tensor, s_pts: Tensor, neighb: Tensor,
                 x: Tensor, extent: float, cfg: KPConvConfig,
                 deformable: bool = False, with_aux: bool = False):
    """q_pts [Nq, 3], s_pts [Ns, 3], neighb [Nq, K] (shadow = Ns), x [Ns, C].

    Mirrors ``KPConv.forward`` (``blocks.py:229-374``). The deformable
    branch (``blocks.py:235-316``) predicts per-point kernel offsets with a
    nested rigid KPConv, optionally modulates per-kernel-point contributions
    by ``2*sigmoid``, and prunes neighbors outside every deformed kernel's
    ``extent`` by remapping them to the shadow index, which is
    value-identical to the reference's shrinking of the neighbor axis
    (their gathered features are zero, so they drop out of both the
    weighted sum and the neighbor-count normalization).

    With ``with_aux`` returns ``(out, aux)`` where aux carries ``min_d2``
    [Nq, Kp] (squared distance of each deformed kernel point to its nearest
    neighbor, ``blocks.py:295``) and ``deformed_kp`` [Nq, Kp, 3].
    """
    kernel_points = p["kernel_points"].detach()
    neighb = neighb.long()
    s_pad = _pad_row(s_pts, 1e6)

    neighbors = s_pad[neighb] - q_pts[:, None]          # [Nq, K, 3]
    # ||n - kp||^2 expanded: avoids the [Nq, K, Kp, 3] difference tensor
    n2 = (neighbors * neighbors).sum(-1)                 # [Nq, K]
    aux = {}
    if deformable:
        off = apply_kpconv(p["offset_conv"], q_pts, s_pts, neighb, x,
                           extent, cfg) + p["offset_bias"]
        k, d = cfg.num_kernel_points, cfg.in_points_dim
        if cfg.modulated:
            unscaled = off[:, :d * k].reshape(-1, k, d)
            modulations = 2.0 * torch.sigmoid(off[:, d * k:])  # [Nq, Kp]
        else:
            unscaled = off.reshape(-1, k, d)
            modulations = None
        # offsets are in units of KP_extent (blocks.py:257-258)
        dkp = kernel_points[None] + unscaled * extent    # [Nq, Kp, 3]
        kp2 = (dkp * dkp).sum(-1)                        # [Nq, Kp]
        cross = torch.einsum("nkd,npd->nkp", neighbors, dkp)
        sq = n2[:, :, None] + kp2[:, None, :] - 2.0 * cross
        sq = sq.clamp_min(0.0)
        # nearest-neighbor distance per deformed kernel point, computed
        # BEFORE pruning like the reference (blocks.py:295)
        aux = {"min_d2": sq.min(dim=1).values, "deformed_kp": dkp}
        # in-range pruning: neighbors outside every deformed kernel's
        # extent are shadowed out (blocks.py:297-316)
        in_range = (sq < extent ** 2).any(dim=2)         # [Nq, K]
        neighb = torch.where(in_range, neighb, s_pts.shape[0])
    else:
        modulations = None
        kp2 = (kernel_points * kernel_points).sum(-1)    # [Kp]
        cross = torch.einsum("nkd,pd->nkp", neighbors, kernel_points)
        sq = n2[:, :, None] + kp2[None, None, :] - 2.0 * cross  # [Nq, K, Kp]
        sq = sq.clamp_min(0.0)

    if cfg.KP_influence == "constant":
        w = torch.ones_like(sq)
    elif cfg.KP_influence == "linear":
        w = (1.0 - torch.sqrt(sq.clamp_min(1e-12)) / extent).clamp_min(0.0)
    elif cfg.KP_influence == "gaussian":
        sigma = extent * 0.3
        w = torch.exp(-sq / (2 * sigma ** 2 + 1e-9))
    else:
        raise ValueError(cfg.KP_influence)

    if cfg.aggregation_mode == "closest":
        closest = sq.argmin(dim=2)
        w = w * torch.nn.functional.one_hot(
            closest, cfg.num_kernel_points).to(w.dtype)
    elif cfg.aggregation_mode != "sum":
        raise ValueError(cfg.aggregation_mode)

    w = w.transpose(1, 2)                                # [Nq, Kp, K]
    neighb_x = gather_rows(_pad_row(x, 0.0), neighb)     # [Nq, K, C]
    weighted = torch.einsum("npk,nkc->npc", w, neighb_x)  # [Nq, Kp, C]
    if modulations is not None:
        weighted = weighted * modulations[:, :, None]    # blocks.py:357-358
    out = torch.einsum("npc,pcd->nd", weighted, p["weights"])

    # neighbor-count normalization: count neighbors whose feature sum > 0
    # (reference quirk, blocks.py:369-372 — shadows have zero features)
    n_valid = (neighb_x.sum(-1) > 0.0).sum(-1).clamp_min(1)
    out = out / n_valid[:, None].to(out.dtype)
    if with_aux:
        return out, aux
    return out


def instance_norm(x: Tensor, valid: Tensor | None, use_bn: bool,
                  bias: Tensor | None = None, eps: float = 1e-5) -> Tensor:
    """Per-channel normalization over (valid) stacked rows; or bias-only."""
    if not use_bn:
        return x + bias
    if valid is None:
        mean = x.mean(dim=0, keepdim=True)
        var = x.var(dim=0, keepdim=True, correction=0)
    else:
        w = valid[:, None].to(x.dtype)
        n = w.sum().clamp_min(1.0)
        mean = (x * w).sum(dim=0, keepdim=True) / n
        var = (((x - mean) ** 2) * w).sum(dim=0, keepdim=True) / n
    y = (x - mean) * torch.rsqrt(var + eps)
    if valid is not None:
        y = torch.where(valid[:, None], y, 0.0)
    return y


def leaky_relu(x: Tensor) -> Tensor:
    return torch.nn.functional.leaky_relu(x, 0.1)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def init_unary(gen: torch.Generator, in_dim: int, out_dim: int,
               cfg: KPConvConfig) -> dict:
    p = {"w": _kaiming_uniform(gen, (in_dim, out_dim), in_dim)}
    if not cfg.use_batch_norm:
        p["bias"] = torch.zeros(out_dim)
    return p


def apply_unary(p: dict, x: Tensor, valid: Tensor | None, cfg: KPConvConfig,
                no_relu: bool = False) -> Tensor:
    x = x @ p["w"]
    x = instance_norm(x, valid, cfg.use_batch_norm, p.get("bias"))
    if not no_relu:
        x = leaky_relu(x)
    return x


def init_simple_block(gen: torch.Generator, in_dim: int, out_dim: int,
                      radius: float, cfg: KPConvConfig,
                      deformable: bool = False) -> dict:
    p = {"kpconv": init_kpconv(gen, in_dim, out_dim // 2, radius, cfg,
                               deformable=deformable)}
    if not cfg.use_batch_norm:
        p["bias"] = torch.zeros(out_dim // 2)
    return p


def apply_simple_block(p: dict, x: Tensor, q_pts, s_pts, neighb, q_valid,
                       radius: float, cfg: KPConvConfig) -> Tensor:
    # deformable iff the params carry an offset conv; the block extent is
    # radius*KP_extent/conv_radius even for deformable (blocks.py:546)
    extent = radius * cfg.KP_extent / cfg.conv_radius
    x = apply_kpconv(p["kpconv"], q_pts, s_pts, neighb, x, extent, cfg,
                     deformable="offset_conv" in p["kpconv"])
    return leaky_relu(instance_norm(x, q_valid, cfg.use_batch_norm,
                                    p.get("bias")))


def init_resnetb_block(gen: torch.Generator, in_dim: int, out_dim: int,
                       radius: float, cfg: KPConvConfig,
                       deformable: bool = False) -> dict:
    p: dict[str, Any] = {}
    if in_dim != out_dim // 4:
        p["unary1"] = init_unary(gen, in_dim, out_dim // 4, cfg)
    p["kpconv"] = init_kpconv(gen, out_dim // 4, out_dim // 4, radius, cfg,
                              deformable=deformable)
    if not cfg.use_batch_norm:
        p["bias_conv"] = torch.zeros(out_dim // 4)
    p["unary2"] = init_unary(gen, out_dim // 4, out_dim, cfg)
    if in_dim != out_dim:
        p["shortcut"] = init_unary(gen, in_dim, out_dim, cfg)
    return p


def max_pool(x: Tensor, inds: Tensor) -> Tensor:
    """[Ns, C] features, [Nq, K] indices (shadow = Ns) -> [Nq, C] max."""
    return gather_rows(_pad_row(x, 0.0), inds.long()).max(dim=1).values


def closest_pool(x: Tensor, inds: Tensor) -> Tensor:
    """Pool from the first (closest) neighbor column (``blocks.py:71-83``)."""
    return gather_rows(_pad_row(x, 0.0), inds[:, 0].long())


def apply_resnetb_block(p: dict, features: Tensor, q_pts, s_pts, neighb,
                        q_valid, s_valid, strided: bool, radius: float,
                        cfg: KPConvConfig) -> Tensor:
    extent = radius * cfg.KP_extent / cfg.conv_radius
    x = features
    if "unary1" in p:
        x = apply_unary(p["unary1"], x, s_valid, cfg)
    x = apply_kpconv(p["kpconv"], q_pts, s_pts, neighb, x, extent, cfg,
                     deformable="offset_conv" in p["kpconv"])
    x = leaky_relu(instance_norm(x, q_valid, cfg.use_batch_norm,
                                 p.get("bias_conv")))
    x = apply_unary(p["unary2"], x, q_valid, cfg, no_relu=True)
    shortcut = max_pool(features, neighb) if strided else features
    if "shortcut" in p:
        shortcut = apply_unary(p["shortcut"], shortcut, q_valid, cfg,
                               no_relu=True)
    return leaky_relu(x + shortcut)
