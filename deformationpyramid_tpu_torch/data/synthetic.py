"""Synthetic deformed point-cloud pairs for tests and benchmarks.

A copy of ``make_pair``, ``make_batch``, ``write_4dmatch_suite``,
``write_3dmatch_suite``, ``write_3dmatch_train_suite`` and
``write_multiview_suite`` from
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


def write_3dmatch_suite(root: str, split: str = "3DMatch", n_pairs: int = 20,
                        n_scene: int = 9000, keep: float = 0.7,
                        noise: float = 0.002, seed: int = 0) -> str:
    """Fabricate a 3DMatch-style rigid fragment-pair suite.

    Mirrors the reference info-file layout consumed by ``_3DMatch``
    (``correspondence/datasets/_3dmatch.py``): an info npz
    with rot [P,3,3] / trans [P,3,1] / src [P] / tgt [P] path arrays plus
    per-pair ``gt_cov`` [P,6,6] covariances (identity here — the real
    suite's covariances come from redwood-data; identity makes the
    registration-recall error ``||(t, q_xyz)||^2`` in metric units), and
    per-fragment ``.npy`` clouds. Each pair: one synthetic scene surface,
    two spatially-coherent half-space crops (fragments) with ``keep``
    fraction each, the target fragment moved by a random SE(3) so
    ``R @ src + t`` aligns it — the convention ``ThreeDMatchDataset``
    (and the reference ``:92``) expects.

    Returns the info-file path (``root/split/test_info.npz``).
    """
    import os

    rng = np.random.default_rng(seed)
    frag_dir = os.path.join(root, split, "frags")
    os.makedirs(frag_dir, exist_ok=True)
    rots, transs, src_paths, tgt_paths, covs = [], [], [], [], []
    for i in range(n_pairs):
        scene, _, _ = make_pair(n=n_scene, seed=seed * 500 + i, deform=0.0)
        n_keep = int(n_scene * keep)
        # two coherent half-space crops with guaranteed overlap: opposite
        # quantile cuts along nearby directions keep the middle band shared
        d1 = rng.normal(size=3)
        d1 /= np.linalg.norm(d1)
        d2 = -d1 + 0.3 * rng.normal(size=3)
        d2 /= np.linalg.norm(d2)
        src = scene[np.argsort(scene @ d1)[:n_keep]]
        frag_b = scene[np.argsort(scene @ d2)[:n_keep]]
        # random SE(3): moderate rotation (axis-angle <= ~0.6 rad) like
        # adjacent scan poses; tgt lives in its own frame
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = rng.uniform(0.1, 0.6)
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        rot = (np.eye(3) + np.sin(ang) * K
               + (1 - np.cos(ang)) * (K @ K)).astype(np.float32)
        trans = rng.uniform(-0.3, 0.3, (3, 1)).astype(np.float32)
        tgt = (rot @ frag_b.T + trans).T.astype(np.float32)
        src = (src + rng.normal(scale=noise, size=src.shape)).astype(np.float32)
        tgt = (tgt + rng.normal(scale=noise, size=tgt.shape)).astype(np.float32)
        sp = os.path.join(split, "frags", f"pair{i:03d}_src.npy")
        tp = os.path.join(split, "frags", f"pair{i:03d}_tgt.npy")
        np.save(os.path.join(root, sp), src)
        np.save(os.path.join(root, tp), tgt)
        rots.append(rot)
        transs.append(trans)
        src_paths.append(sp)
        tgt_paths.append(tp)
        covs.append(np.eye(6, dtype=np.float32) * n_keep)
    info_path = os.path.join(root, split, "test_info.npz")
    np.savez(info_path, rot=np.stack(rots), trans=np.stack(transs),
             src=np.array(src_paths), tgt=np.array(tgt_paths),
             gt_cov=np.stack(covs))
    return info_path


def write_3dmatch_train_suite(root: str, split: str, n_pairs: int = 32,
                              n_scene: int = 9000, keep: float = 0.7,
                              noise: float = 0.002, seed: int = 0) -> list[str]:
    """3DMatch-regime rigid pairs in the 4DMatch npz layout.

    ``write_4dmatch_suite(rigid=True)`` draws z-only rotations <= 0.2 rad
    with a single-sided target crop, while the ``write_3dmatch_suite``
    fragments carry arbitrary-axis rotations of 0.1-0.6 rad, double-sided
    half-space crops (both fragments are partial) and measurement noise.
    This writer emits training pairs from the same generative process as
    that suite (the reference dataset's convention ``R @ src + t = tgt``,
    ``correspondence/datasets/_3dmatch.py:92``), so that ``train_matcher``
    trains at the regime it is evaluated at. Correspondences are the exact
    fragment-overlap index map (shared scene points); the flow is zero.
    """
    import os

    rng = np.random.default_rng(seed)
    out_dir = os.path.join(root, split, "seq0")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(n_pairs):
        scene, _, _ = make_pair(n=n_scene, seed=seed * 700 + i, deform=0.0)
        n_keep = int(n_scene * keep)
        d1 = rng.normal(size=3)
        d1 /= np.linalg.norm(d1)
        d2 = -d1 + 0.3 * rng.normal(size=3)
        d2 /= np.linalg.norm(d2)
        src_idx = np.argsort(scene @ d1)[:n_keep]
        tgt_idx = np.argsort(scene @ d2)[:n_keep]
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = rng.uniform(0.1, 0.6)
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        rot = (np.eye(3) + np.sin(ang) * K
               + (1 - np.cos(ang)) * (K @ K)).astype(np.float32)
        trans = rng.uniform(-0.3, 0.3, (3, 1)).astype(np.float32)
        src = (scene[src_idx]
               + rng.normal(scale=noise, size=(n_keep, 3))).astype(np.float32)
        tgt = ((rot @ scene[tgt_idx].T + trans).T
               + rng.normal(scale=noise, size=(n_keep, 3))).astype(np.float32)
        # overlap correspondences: positions of shared scene points in each
        # fragment's row order
        pos_in_tgt = np.full(n_scene, -1, np.int64)
        pos_in_tgt[tgt_idx] = np.arange(n_keep)
        shared = pos_in_tgt[src_idx] >= 0
        corr = np.stack([np.nonzero(shared)[0],
                         pos_in_tgt[src_idx[shared]]], 1)
        path = os.path.join(out_dir, f"pair{i:04d}.npz")
        np.savez(path, rot=rot, trans=trans,
                 s2t_flow=np.zeros((n_keep, 3), np.float32), s_pc=src,
                 t_pc=tgt, correspondences=corr,
                 metric_index=rng.permutation(n_keep)[:500])
        paths.append(path)
    return paths


def write_multiview_suite(root: str, split: str, n_seqs: int = 4,
                          n_views: int = 4, n_pts: int = 500,
                          deform: float = 0.1, seed: int = 0) -> list[str]:
    """Fabricate multiview npz sequences in the ``_4DMatch_Multiview``
    layout (reference ``correspondence/datasets/_4dmatch_multiview.py:61-100``):
    per-sequence pcds [V,N,3], pcd_pairs [P,2], pairwise_flows [P,N,3],
    pairwise_overlap [P,2], poses [V,4,4]. Views are progressive smooth
    deformations of one base cloud, so pairwise flows are consistent by
    construction.
    """
    import os

    rng = np.random.default_rng(seed)
    out_dir = os.path.join(root, split)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for s in range(n_seqs):
        base, _, _ = make_pair(n=n_pts, seed=seed * 100 + s, deform=deform)
        views = [base]
        for v in range(1, n_views):
            disp = deform * np.stack([
                np.sin((1.0 + 0.3 * v) * base[:, 1] + 0.2 * v),
                np.cos((1.2 - 0.1 * v) * base[:, 0] + 0.5 * v),
                0.4 * np.sin(base[:, 0] + 0.6 * v * base[:, 1]),
            ], -1).astype(np.float32)
            views.append(base + disp)
        pcds = np.stack(views)
        pairs, flows, overlaps = [], [], []
        for a in range(n_views):
            for b in range(n_views):
                if a == b:
                    continue
                pairs.append([a, b])
                flows.append(pcds[b] - pcds[a])
                overlaps.append([0.9, 0.9])
        path = os.path.join(out_dir, f"seq{s:03d}.npz")
        np.savez(path, pcds=pcds, pcd_pairs=np.array(pairs, np.int64),
                 pairwise_flows=np.stack(flows).astype(np.float32),
                 pairwise_overlap=np.array(overlaps, np.float32),
                 _2axis_flow=np.zeros((n_views, n_pts, 3), np.float32),
                 axis_node=np.zeros((3,), np.int64),
                 poses=np.tile(np.eye(4, dtype=np.float32),
                               (n_views, 1, 1)))
        paths.append(path)
    return paths
