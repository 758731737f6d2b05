# Frozen copy of deformationpyramid_tpu_torch/data/correspondence_utils.py
# at commit 52465dd567ae528633903efcb67c623d9d527dd1.
"""Host-side correspondence utilities.

A numpy + scipy copy of ``deformationpyramid_tpu/data/correspondence_utils.py``
(importing any module of the JAX package imports JAX, so the port keeps its
own; a parity test holds the copy bit-identical): ``knn_point_np`` /
``mutual_nn_correspondence`` (reference ``model/geometry.py:392-450``) and
``blend_scene_flow`` (``correspondence/datasets/utils.py:42-58``), used for
GT coarse-match construction and flow interpolation in the data pipeline.
"""
from __future__ import annotations

import numpy as np


def knn_point_np(k: int, reference_pts: np.ndarray, query_pts: np.ndarray):
    """kNN of query in reference; returns (dists [Q,k], idx [Q,k]).

    cKDTree query, O(Q log N): the dense [Q, N] matrix this replaces
    (reference ``model/geometry.py:392-410`` does exactly that in numpy)
    allocated ~450 MB and full-argsorted 28k-wide rows at suite scale —
    the eval harvest calls this 2x per pair via ``blend_scene_flow``.
    Exact-tie neighbor ORDER may differ from the dense argsort, but the
    IDW consumer weights equal distances equally, so blends are
    unaffected."""
    from scipy.spatial import cKDTree

    dists, idx = cKDTree(reference_pts).query(query_pts, k=k)
    if k == 1:
        dists, idx = dists[:, None], idx[:, None]
    return dists, idx


class SceneFlowInterp:
    """Reusable IDW flow interpolator: one anchor cKDTree, many query sets.

    ``blend_scene_flow`` rebuilds the tree per call; the eval harvest
    interpolates the SAME pair's flow at two query sets (landmarks and raw
    matches), so sharing the tree halves the per-pair build cost (~19 ms at
    28k anchors). Semantics identical to ``blend_scene_flow``
    (reference ``correspondence/datasets/utils.py:42-58``)."""

    def __init__(self, anchor_pts: np.ndarray, anchor_flow: np.ndarray,
                 knn: int = 3):
        from scipy.spatial import cKDTree

        self._tree = cKDTree(anchor_pts)
        self._flow = anchor_flow
        self._knn = knn

    def __call__(self, query_pts: np.ndarray) -> np.ndarray:
        dists, idx = self._tree.query(query_pts, k=self._knn)
        if self._knn == 1:
            dists, idx = dists[:, None], idx[:, None]
        dists = np.maximum(dists, 1e-10)
        w = 1.0 / dists
        w = w / w.sum(1, keepdims=True)
        return (self._flow[idx] * w[..., None]).sum(1).astype(np.float32)


def mutual_nn_correspondence(src_warped: np.ndarray, tgt: np.ndarray,
                             search_radius: float = 0.3, knn: int = 1) -> np.ndarray:
    """Mutual nearest neighbors within a radius -> [M, 2] (src, tgt) indices.

    Matches ``multual_nn_correspondence`` (``model/geometry.py:432-450``).
    """
    if len(src_warped) == 0 or len(tgt) == 0:
        return np.zeros((0, 2), np.int64)
    d_s2t = np.linalg.norm(src_warped[:, None] - tgt[None], axis=-1)
    s2t = d_s2t.argmin(1)
    t2s = d_s2t.argmin(0)
    src_idx = np.arange(len(src_warped))
    mutual = t2s[s2t] == src_idx
    within = d_s2t[src_idx, s2t] < search_radius
    keep = mutual & within
    return np.stack([src_idx[keep], s2t[keep]], 1).astype(np.int64)


def blend_scene_flow(query_pts: np.ndarray, anchor_pts: np.ndarray,
                     anchor_flow: np.ndarray, knn: int = 3) -> np.ndarray:
    """IDW-blend flow from k nearest anchors (``datasets/utils.py:42-58``)."""
    dists, idx = knn_point_np(knn, anchor_pts, query_pts)
    dists = np.maximum(dists, 1e-10)
    w = 1.0 / dists
    w = w / w.sum(1, keepdims=True)
    return (anchor_flow[idx] * w[..., None]).sum(1).astype(np.float32)
