"""Differentiable point-cloud depth / silhouette renderer and the
point-to-plane distance.

Counterpart of ``deformationpyramid_tpu/ops/render.py`` (which replaces the
reference's pytorch3d rasterizer, ``model/point_render.py:36-105``, used by
``silhouette_cost``, ``model/loss.py:288-345``): points are projected with
the pinhole intrinsics and z-buffered by a scatter-min over a dense pixel
grid, ``scatter_reduce(..., "amin")`` here. Each point splats to the one
pixel that contains it, as in the JAX package.

Gradients reach the winning point's depth. At a z-tie (two points of one
pixel at the same depth) both packages split the pixel's gradient evenly
among the tied points: torch's ``amin`` backward divides it by the number
of elements equal to the minimum, JAX's scatter-min JVP averages the
contenders' tangents (``jax/_src/lax/slicing.py _scatter_extremal_jvp``).
The empty-pixel fill ``_FAR`` never ties with a real depth.

``point_2_plane_distance`` takes its two 1-NN searches from
:func:`ops.knn.nn_argmin`, kernel C14 on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from .knn import nn_argmin

Tensor = torch.Tensor

_FAR = 1e6


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    height: int = 480
    width: int = 640


def render_depth_silhouette(points: Tensor, intrinsics: Tensor,
                            cfg: RenderConfig,
                            valid: Tensor | None = None
                            ) -> tuple[Tensor, Tensor]:
    """points [N, 3] camera-frame -> (depth [H, W], silhouette [H, W]).

    depth = 0 where no point projects (the reference maps empty pixels to 0
    after the INF round-trip, ``loss.py:299-305``); silhouette in {0, 1}.
    The pixel coordinates truncate toward zero, as JAX's ``astype(int32)``.
    """
    fx, cx = intrinsics[0, 0], intrinsics[0, 2]
    fy, cy = intrinsics[1, 1], intrinsics[1, 2]
    z = points[:, 2]
    ok = z > 1e-6
    if valid is not None:
        ok = ok & valid
    zs = torch.where(ok, z, 1.0)
    u = (fx * points[:, 0] / zs + cx).to(torch.int32)
    v = (fy * points[:, 1] / zs + cy).to(torch.int32)
    inside = ok & (u >= 0) & (u < cfg.width) & (v >= 0) & (v < cfg.height)
    n_pix = cfg.height * cfg.width
    flat = torch.where(inside, v * cfg.width + u, n_pix).to(torch.int64)

    depth_flat = torch.full((n_pix + 1,), _FAR, dtype=points.dtype,
                            device=points.device)
    depth_flat = depth_flat.scatter_reduce(
        0, flat, torch.where(inside, z, _FAR), "amin", include_self=True)
    depth = depth_flat[:-1].reshape(cfg.height, cfg.width)
    sil = (depth < _FAR).to(points.dtype)
    depth = torch.where(depth < _FAR, depth, 0.0)
    return depth, sil


def silhouette_cost(x: Tensor, y: Tensor, intrinsics: Tensor,
                    cfg: RenderConfig, depth_trunc: float = 0.06) -> Tensor:
    """Rendered silhouette + truncated depth comparison
    (``model/loss.py:288-345``): the silhouette error outside the target
    mask, the squared depth error inside both masks with errors above
    ``depth_trunc^2`` zeroed (gradient cut, like the reference's indexed
    assign)."""
    dx, px = render_depth_silhouette(x, intrinsics, cfg)
    dy, py = render_depth_silhouette(y, intrinsics, cfg)
    x_mask = px > 0
    y_mask = py > 0

    silh_error = (px - py) ** 2
    silh_outside = torch.where(~y_mask, silh_error, 0.0)
    n_out = torch.clamp_min((~y_mask).sum(), 1)
    silh_loss = torch.sum(silh_outside) / n_out

    both = x_mask & y_mask
    depth_error = (dx - dy) ** 2
    keep = both & (depth_error <= depth_trunc ** 2)
    n_both = torch.clamp_min(both.sum(), 1)
    depth_loss = torch.sum(torch.where(keep, depth_error, 0.0)) / n_both
    return silh_loss + depth_loss


def point_2_plane_distance(x: Tensor, y: Tensor, x_normals: Tensor,
                           y_normals: Tensor
                           ) -> tuple[Tensor, Tensor, Tensor]:
    """Two-sided point-to-plane distance (``model/loss.py:61-92``).

    Returns (total, x_to_plane, y_to_plane). The nearest neighbours come
    from :func:`nn_argmin` (C14 on the card, once each way) and carry no
    gradient.
    """
    with torch.no_grad():
        _, idx_x = nn_argmin(x.detach(), y.detach())
        _, idx_y = nn_argmin(y.detach(), x.detach())
    x_ref_n = y_normals[idx_x]
    x_ref_p = y[idx_x]
    y_ref_n = x_normals[idx_y]
    y_ref_p = x[idx_y]
    x2p = torch.sqrt(torch.clamp_min(
        torch.sum(((x - x_ref_p) * x_ref_n) ** 2, dim=1), 1e-16)).mean()
    y2p = torch.sqrt(torch.clamp_min(
        torch.sum(((y - y_ref_p) * y_ref_n) ** 2, dim=1), 1e-16)).mean()
    return x2p + y2p, x2p, y2p
