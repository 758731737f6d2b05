"""Synthetic deformed point-cloud pairs for tests and benchmarks.

A copy of ``make_pair``, ``make_batch`` and ``write_4dmatch_suite`` from
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


def write_4dmatch_suite(root: str, split: str, n_pairs: int = 100,
                        size_clusters: tuple[int, ...] = (1500, 3000, 8000,
                                                          15000, 28000),
                        seed: int = 0, partial: float = 0.85,
                        deform: float = 0.12,
                        occlusion: str = "uniform",
                        rigid: bool = False) -> list[str]:
    """Fabricate a 4DMatch-format npz suite at realistic point counts.

    Emits the exact reference field layout (``_4dmatch.py:60-73``): rot /
    trans / s2t_flow / s_pc / t_pc / correspondences / metric_index, with
    GT convention R (Ps + flow) + t = Pt. Point counts are drawn from
    ``size_clusters`` (+-8% jitter) so the BucketBatcher sees a handful of
    compiled shapes, mirroring 4DMatch's clustered cloud sizes. The target
    keeps a ``partial`` fraction of points.

    ``occlusion`` picks HOW the dropped target points are chosen:

    * ``uniform`` — i.i.d. random dropout. Preserves full surface
      coverage, so truncated chamfer still sees every region: a *sparsity*
      regime, not an occlusion regime.
    * ``coherent`` — spatially-coherent culls, the synthetic stand-in for
      real 4DLoMatch visibility occlusion (reference ``README.md:21``;
      occluded-split metrics ``model/loss.py:431-471``): even pairs drop a
      half-space (random plane direction, quantile cut at ``partial``),
      odd pairs drop a contiguous ball (the ``(1-partial)·n`` nearest
      points to a random surface point). Source points whose correspondent
      was culled have NO true chamfer attractor — the regime where
      landmark-guided registration is supposed to win.
    """
    import os

    rng = np.random.default_rng(seed)
    out_dir = os.path.join(root, split, "seq0")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(n_pairs):
        base = int(rng.choice(size_clusters))
        n = int(base * (1.0 + rng.uniform(-0.08, 0.08)))
        src, tgt_dense, flow = make_pair(n=n, seed=seed * 1000 + i,
                                         deform=0.0 if rigid else deform)
        if rigid:
            # 3DMatch-style rigid pairs in the 4DMatch npz layout: zero
            # s2t_flow, all motion in (rot, trans) — lets train_matcher
            # consume rigid data unchanged
            flow = np.zeros_like(flow)
        ang = float(rng.uniform(-0.2, 0.2))
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        trans = rng.uniform(-0.1, 0.1, (3, 1)).astype(np.float32)
        tgt = (rot @ (src + flow).T + trans).T.astype(np.float32)
        n_keep = int(n * partial)
        if occlusion == "uniform":
            keep_t = rng.permutation(n)[:n_keep]
        elif occlusion == "coherent":
            if i % 2 == 0:
                # half-space cull: keep the n_keep points lowest along a
                # random direction
                d = rng.normal(size=3)
                d /= np.linalg.norm(d)
                keep_t = np.argsort(tgt @ d)[:n_keep]
            else:
                # contiguous-patch cull: drop the (n-n_keep) points nearest
                # a random surface point
                center = tgt[rng.integers(n)]
                d2 = np.sum((tgt - center) ** 2, axis=1)
                keep_t = np.argsort(d2)[n - n_keep:]
        else:
            raise ValueError(f"unknown occlusion mode {occlusion!r}")
        corr = np.stack([keep_t, np.arange(len(keep_t))], 1)
        path = os.path.join(out_dir, f"pair{i:04d}.npz")
        np.savez(path, rot=rot, trans=trans, s2t_flow=flow, s_pc=src,
                 t_pc=tgt[keep_t], correspondences=corr,
                 metric_index=rng.permutation(n)[:500])
        paths.append(path)
    return paths
