"""Depth / camera geometry on the host (numpy).

A copy of ``deformationpyramid_tpu/geometry/camera.py`` (the port imports
nothing of the JAX package; a CPU test holds the copy bit-identical).
Reference parity: ``depth_2_pc`` (``model/geometry.py:91-106``), ``pc_2_uv``
(``:76-87``), ``map_pixel_to_pcd`` (``:53-61``).
"""
from __future__ import annotations

import numpy as np


def depth_to_pointcloud(depth: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """Back-project a depth map [H, W] (meters) to a [3, H, W] point image."""
    fx, cx = intrinsics[0, 0], intrinsics[0, 2]
    fy, cy = intrinsics[1, 1], intrinsics[1, 2]
    h, w = depth.shape
    u = np.arange(w)[None, :] * np.ones((h, w))
    v = np.arange(h)[:, None] * np.ones((h, w))
    X = (u - cx) * depth / fx
    Y = (v - cy) * depth / fy
    return np.stack([X, Y, depth])


def pointcloud_to_uv(pcd: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """Project [N, 3] points to integer pixel coordinates [N, 2] (u, v)."""
    X, Y, Z = pcd[:, 0], pcd[:, 1], pcd[:, 2]
    fx, cx = intrinsics[0, 0], intrinsics[0, 2]
    fy, cy = intrinsics[1, 1], intrinsics[1, 2]
    u = (fx * X / Z + cx).astype(np.int64)
    v = (fy * Y / Z + cy).astype(np.int64)
    return np.stack([u, v], -1)


def map_pixel_to_pcd(valid_pix_mask: np.ndarray) -> np.ndarray:
    """[H, W] bool -> [H, W] int map from pixel to point index, -1 invalid."""
    flat = valid_pix_mask.reshape(-1)
    idx = np.cumsum(flat).reshape(valid_pix_mask.shape).astype(np.int64) - 1
    idx[~valid_pix_mask] = -1
    return idx
