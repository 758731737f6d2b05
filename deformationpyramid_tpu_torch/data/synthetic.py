"""Synthetic deformed point-cloud pairs for tests and benchmarks.

A copy of ``make_pair`` and ``make_batch`` from
``deformationpyramid_tpu/data/synthetic.py``: importing any module of the
JAX package imports JAX, so the port keeps its own numpy generators. The
parity tests hold the two copies bit-identical.
"""
from __future__ import annotations

import numpy as np


def make_pair(n: int = 2000, seed: int = 0, deform: float = 0.15,
              rigid: bool = False) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sample a wavy-surface source cloud and a smoothly deformed target.

    Returns (src [n,3], tgt [n,3], flow_gt [n,3]) where tgt = src + flow_gt
    point-for-point (correspondence known by construction).
    """
    rng = np.random.default_rng(seed)
    uv = rng.random((n, 2), dtype=np.float64) * 2.0 - 1.0
    z = 0.3 * np.sin(2.0 * uv[:, 0]) * np.cos(2.0 * uv[:, 1])
    src = np.stack([uv[:, 0], uv[:, 1], z], -1)

    if rigid:
        ang = deform
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        tgt = src @ R.T + np.array([0.1, -0.05, 0.02]) * deform / 0.15
    else:
        # smooth low-frequency displacement field
        disp = deform * np.stack([
            np.sin(1.3 * src[:, 1] + 0.2),
            np.cos(1.1 * src[:, 0] - 0.4),
            0.5 * np.sin(0.9 * src[:, 0] + 0.7 * src[:, 1]),
        ], -1)
        tgt = src + disp
    flow = tgt - src
    return src.astype(np.float32), tgt.astype(np.float32), flow.astype(np.float32)


def make_batch(b: int, n: int = 2000, seed: int = 0, deform: float = 0.15):
    """Batch of b synthetic pairs, distinct geometry per pair."""
    srcs, tgts, flows = [], [], []
    for i in range(b):
        s, t, f = make_pair(n=n, seed=seed + i, deform=deform)
        srcs.append(s); tgts.append(t); flows.append(f)
    return np.stack(srcs), np.stack(tgts), np.stack(flows)
