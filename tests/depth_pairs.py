"""Fabricated depth-map pairs for the ED / N-ICP evaluation (test data).

A bumpy surface seen by a pinhole camera at 1.3-1.7 m, and the same
surface after a bend and a rigid move (a tilt and a shift, mostly along the
viewing direction), z-buffered into the target depth map
with numpy (``np.minimum.at``). ``write_ed_split`` writes them as a
4DMatch-format split whose npz files carry ``depth_paths`` and
``cam_intrin``, the fields that ``data/fourdmatch.py`` reads for
``cli/eval_ed.py``: ``s_pc`` is a sample of the source vertices,
``s2t_flow`` their displacement, every one of them in the overlap.

Used at small sizes by the port's CPU tests and at 480 x 640 by
``chip_smoke.py``, where the surface covers ~40k pixels, so that the clouds
are the size of the largest fabricated 4DMatch-F pairs.
"""
from __future__ import annotations

import os

import numpy as np


def zbuffer(points: np.ndarray, K: np.ndarray, h: int, w: int
            ) -> np.ndarray:
    """Depth map [h, w] (0 where empty) of float32 camera-frame points,
    projected in float32 in the order ``ops/render.py`` projects them, so
    that each point lands on the renderer's pixel."""
    p = points.astype(np.float32)
    f = K.astype(np.float32)
    z = p[:, 2]
    ok = z > np.float32(1e-6)
    zs = np.where(ok, z, np.float32(1.0))
    u = (f[0, 0] * p[:, 0] / zs + f[0, 2]).astype(np.int32)
    v = (f[1, 1] * p[:, 1] / zs + f[1, 2]).astype(np.int32)
    inside = ok & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    depth = np.full(h * w, np.inf, np.float32)
    np.minimum.at(depth, v[inside] * w + u[inside], z[inside])
    depth[np.isinf(depth)] = 0.0
    return depth.reshape(h, w)


def make_depth_pair(h: int = 480, w: int = 640, seed: int = 0) -> dict:
    """One pair: the source depth map and its vertices, the moved vertices
    and their z-buffered depth map, the intrinsics (fx, fy ~ 500 and
    (cx, cy) ~ (320, 240) at 640 x 480, scaled with the width).

    config/baselines/NICP.yaml registers such a pair to 0.28-0.39 of its
    initial flow (4 seeds at 480 x 640, on the CPU). ED's chamfer, on 2000
    resampled points, holds two scans together along the viewing
    direction but lets them slide along each other: on smooth relief, or
    under a slide along the surface, its flow error stays near the
    initial flow. Hence 40 narrow bumps (3-6 cm high, 0.06-0.12 of the
    surface's half-axes wide) and a move mostly along the viewing
    direction (a 4 cm shift in depth, a tilt of 2-4 degrees about an axis
    in the image plane, a 3 cm bend in depth)."""
    rng = np.random.default_rng(seed)
    s = w / 640.0
    fx, fy = 500.0 * s * rng.uniform(0.99, 1.01, 2)
    K = np.array([[fx, 0.0, w / 2 + rng.uniform(-2, 2) * s],
                  [0.0, fy, h / 2 + rng.uniform(-2, 2) * s],
                  [0.0, 0.0, 1.0]])
    vv, uu = np.mgrid[0:h, 0:w].astype(np.float64)
    a, b = 0.203 * w, 0.205 * h               # ~40.0k pixels at 640 x 480
    uc = w / 2 + rng.uniform(-0.05, 0.05) * w
    vc = h / 2 + rng.uniform(-0.05, 0.05) * h
    su, sv = (uu - uc) / a, (vv - vc) / b
    mask = su ** 2 + sv ** 2 <= 1.0
    z0 = rng.uniform(1.3, 1.7)
    # a shallow bowl with bumps and dents: relief that a chamfer between
    # two scans can hold on to
    depth = z0 + 0.05 * su ** 2
    for _ in range(40):
        bu, bv = rng.uniform(-0.8, 0.8, 2)
        a_k = rng.choice([-1.0, 1.0]) * rng.uniform(0.03, 0.06)
        sig = rng.uniform(0.06, 0.12)
        depth = depth + a_k * np.exp(-((su - bu) ** 2 + (sv - bv) ** 2)
                                     / (2 * sig ** 2))
    depth = np.where(mask, depth, 0.0)
    depth_mm = (depth * 1000.0).astype(np.float32)

    d = depth_mm.astype(np.float64) / 1000.0     # as the graph build reads it
    X = (uu - K[0, 2]) * d / K[0, 0]
    Y = (vv - K[1, 2]) * d / K[1, 1]
    valid = d > 0
    src = np.stack([X[valid], Y[valid], d[valid]], 1)

    # a bend in depth across the surface, then a rigid move about its centre
    c = src.mean(0)
    half = np.abs(src[:, 0] - c[0]).max()
    bent = src.copy()
    bent[:, 2] += 0.03 * ((src[:, 0] - c[0]) / half) ** 2
    # a tilt (axis in the image plane): the move is mostly along the
    # viewing direction, which a chamfer between two depth scans can see;
    # a slide along the surface it mostly cannot
    axis = np.array([*rng.normal(size=2), 0.0])
    axis /= np.linalg.norm(axis)
    ang = np.deg2rad(rng.uniform(2.0, 4.0))
    W = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(ang) * W + (1 - np.cos(ang)) * W @ W
    t = np.array([0.0, 0.0, 0.04]) * rng.uniform(0.8, 1.2, 3)
    tgt = (bent - c) @ R.T + c + t
    tgt_depth = zbuffer(tgt, K, h, w)
    return {"K": K, "src_depth_mm": depth_mm,
            "tgt_depth_mm": (tgt_depth * 1000.0).astype(np.float32),
            "tgt_depth_m": tgt_depth,
            "src": src.astype(np.float32), "tgt": tgt.astype(np.float32),
            "flow": (tgt - src).astype(np.float32)}


def write_ed_split(root: str, split: str = "4DMatch-F", n_pairs: int = 2,
                   h: int = 480, w: int = 640, seed: int = 0,
                   n_eval: int = 20000) -> list[dict]:
    """Write ``n_pairs`` depth pairs under ``root/split/scene/`` (npz + the
    two depth maps as .npy, in mm); returns the pairs of
    :func:`make_depth_pair`, each with its npz path."""
    out = []
    scene = os.path.join(root, split, "depth_scene")
    os.makedirs(scene, exist_ok=True)
    for i in range(n_pairs):
        pair = make_depth_pair(h, w, seed + i)
        rng = np.random.default_rng(1000 + seed + i)
        pick = np.sort(rng.permutation(len(pair["src"]))[:n_eval])
        sp = os.path.join(scene, f"pair_{i:03d}_src_depth.npy")
        tp = os.path.join(scene, f"pair_{i:03d}_tgt_depth.npy")
        np.save(sp, pair["src_depth_mm"])
        np.save(tp, pair["tgt_depth_mm"])
        k = len(pick)
        path = os.path.join(scene, f"pair_{i:03d}.npz")
        np.savez(path, s_pc=pair["src"][pick], t_pc=pair["tgt"][pick],
                 s2t_flow=pair["flow"][pick], rot=np.eye(3, dtype=np.float32),
                 trans=np.zeros((3, 1), np.float32),
                 correspondences=np.stack([np.arange(k), np.arange(k)], 1),
                 depth_paths=np.array([sp, tp]), cam_intrin=pair["K"])
        out.append(dict(pair, npz=path))
    return out
