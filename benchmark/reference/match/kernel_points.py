# Frozen copy of deformationpyramid_tpu_torch/match/kernel_points.py at commit
# 52465dd567ae528633903efcb67c623d9d527dd1: the einsum (plain) route only, for the
# benchmark's reference; it imports nothing of the port.
"""Kernel point dispositions for KPConv.

The reference optimizes kernel positions by repulsive potential descent and
caches them to .ply files, then applies a random rotation + jitter at load
(``correspondence/kernels/kernel_points.py:246-470``). Here
the disposition is computed deterministically (fixed seed, no load-time
randomization — SURVEY.md §7 "make deterministic ... for eval parity") and
cached in-process. KPConv weights adapt to whatever disposition they are
trained with, so determinism, not the exact geometry, is what matters.

A numpy copy of ``deformationpyramid_tpu/match/kernel_points.py``, held
bit-identical to it by ``tests/test_torch_match_collate.py``.
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=8)
def kernel_dispositions(num_kpoints: int = 15, dimension: int = 3,
                        fixed: str = "center", radius: float = 1.0,
                        seed: int = 42, n_iter: int = 300) -> np.ndarray:
    """Optimize ``num_kpoints`` kernel positions inside the unit sphere.

    Points repel each other (inverse-square) and are attracted to the sphere
    interior; with ``fixed='center'`` the first point is pinned at the
    origin. Returns [K, dim] scaled so the average point norm is ~0.66 *
    radius * 1.5 (the KPConv convention: dispositions are later multiplied
    by KP_extent-relative scale through the conv radius).
    """
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(num_kpoints, dimension))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True) + 1e-9
    pts *= rng.random((num_kpoints, 1)) ** (1.0 / dimension)
    if fixed == "center":
        pts[0] = 0.0

    step = 0.05
    for _ in range(n_iter):
        diff = pts[:, None] - pts[None]                     # [K, K, d]
        d2 = np.sum(diff ** 2, axis=-1) + 1e-9
        np.fill_diagonal(d2, np.inf)
        rep = np.sum(diff / (d2[..., None] ** 1.5), axis=1)  # repulsion
        norms = np.linalg.norm(pts, axis=1, keepdims=True)
        # radial spring keeps points inside the unit ball
        attract = -pts * np.maximum(norms - 1.0, 0.0) * 10.0 - pts * 0.5
        grad = rep * 0.05 + attract
        if fixed == "center":
            grad[0] = 0.0
        if fixed == "verticals":
            grad[:3, :-1] = 0.0
        pts = pts + step * grad / (np.linalg.norm(grad, axis=1, keepdims=True) + 1e-9)
        step *= 0.995

    # normalize the mean radius to 0.66 then apply the KPConv 1.5x scale,
    # matching the reference convention (kernel_points.py:443-449: kernels
    # are scaled by radius * 1.5 / AVG_NORM-style normalization)
    mean_norm = np.mean(np.linalg.norm(pts[1:] if fixed == "center" else pts, axis=1))
    pts = pts / (mean_norm + 1e-9) * 0.66
    return (pts * radius * 1.5).astype(np.float32)
