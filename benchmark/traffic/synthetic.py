"""The benchmark's generator of point-cloud pairs.

Frozen copy of ``make_pair`` and ``make_batch`` and of the per-pair body
of ``write_4dmatch_suite`` (its 4DMatch-F settings: size clusters
1500 / 3000 / 8000 / 15000 / 28000 points +-8%, partial 0.85, deform
0.12, uniform occlusion), from
``deformationpyramid_tpu_torch/data/synthetic.py`` at commit
52465dd567ae528633903efcb67c623d9d527dd1. The suite writer saves npz
files; here a pair is made in memory, with the same draws.

Every traffic file under ``traffic/`` is parameters of these generators;
the drivers read them.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def make_pair(n: int = 2000, seed: int = 0, deform: float = 0.15,
              rigid: bool = False) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A wavy-surface source cloud and its smoothly deformed target:
    (src [n, 3], tgt [n, 3], flow_gt [n, 3]), tgt = src + flow_gt row for
    row."""
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
        disp = deform * np.stack([
            np.sin(1.3 * src[:, 1] + 0.2),
            np.cos(1.1 * src[:, 0] - 0.4),
            0.5 * np.sin(0.9 * src[:, 0] + 0.7 * src[:, 1]),
        ], -1)
        tgt = src + disp
    flow = tgt - src
    return (src.astype(np.float32), tgt.astype(np.float32),
            flow.astype(np.float32))


def make_batch(b: int, n: int = 2000, seed: int = 0, deform: float = 0.15):
    """b pairs of distinct geometry (pair i from seed + i)."""
    srcs, tgts, flows = [], [], []
    for i in range(b):
        s, t, f = make_pair(n=n, seed=seed + i, deform=deform)
        srcs.append(s)
        tgts.append(t)
        flows.append(f)
    return np.stack(srcs), np.stack(tgts), np.stack(flows)


@dataclasses.dataclass
class Pair:
    """One 4DMatch-format pair in memory (``write_4dmatch_suite``'s
    fields): R (src + flow) + t = tgt on the kept target rows."""

    src: np.ndarray
    tgt: np.ndarray
    flow: np.ndarray
    rot: np.ndarray
    trans: np.ndarray
    cluster: int


def fourdmatch_pair(base: int, seed: int, partial: float = 0.85,
                    deform: float = 0.12, jitter: float = 0.08) -> Pair:
    """One pair of ``write_4dmatch_suite`` with uniform occlusion, its size
    cluster ``base`` given (the suite draws it), and every other draw from
    ``seed``: the size jitter of +-``jitter``, the geometry, the rigid
    motion and the kept target rows."""
    rng = np.random.default_rng(seed)
    n = int(base * (1.0 + rng.uniform(-jitter, jitter)))
    src, _, flow = make_pair(n=n, seed=int(rng.integers(1 << 31)),
                             deform=deform)
    ang = float(rng.uniform(-0.2, 0.2))
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    trans = rng.uniform(-0.1, 0.1, (3, 1)).astype(np.float32)
    tgt = (rot @ (src + flow).T + trans).T.astype(np.float32)
    keep_t = rng.permutation(n)[:int(n * partial)]
    return Pair(src, tgt[keep_t], flow, rot, trans, base)


def stratified_pool(clusters, per_cluster: int, seed: int,
                    **kw) -> list[Pair]:
    """``per_cluster`` pairs of each size cluster, in an order drawn from
    ``seed``: every seed gets the same mix of sizes."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(clusters) * per_cluster)
    seeds = rng.integers(0, 1 << 62, size=len(order))
    bases = [clusters[i // per_cluster] for i in order]
    return [fourdmatch_pair(b, int(s), **kw) for b, s in zip(bases, seeds)]
