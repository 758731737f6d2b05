"""4DMatch / 4DLoMatch npz dataset reader and bucketed batcher.

A numpy copy of ``deformationpyramid_tpu/data/fourdmatch.py`` (the port
imports nothing of the JAX package; a parity test holds the copy
bit-identical, the augmentation's random stream included).

Parity with the reference ``_4DMatch`` dataset
(``correspondence/datasets/_4dmatch.py:14-153``):

* layout: ``{data_root}/{split}/*/*.npz`` with fields
  rot [3,3], trans [3,1], s2t_flow [Ns,3], s_pc [Ns,3], t_pc [Nt,3],
  correspondences [C,2], metric_index (4DLoMatch only),
* GT convention: ``R @ (s_pc + flow) + t = t_pc`` (``_4dmatch.py:152``),
  so the evaluated scene flow is ``R(Ps + flow) + t - Ps``
  (``eval_nolearned.py:75-78``),
* 30k-point cap by random downsample (``_4dmatch.py:92-98``),
* optional train-time augmentation: random SO(3) applied to src or tgt +
  gaussian noise (``_4dmatch.py:116-131``).

Device-side consumption is batched and padded: :class:`BucketBatcher` groups
pairs into power-of-two shape buckets so the compiled registration program
is reused across the sweep (SURVEY.md "Hard parts": variable point counts).
"""
from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np


@dataclasses.dataclass
class Pair:
    src: np.ndarray           # [Ns, 3] float32
    tgt: np.ndarray           # [Nt, 3] float32
    flow_gt: np.ndarray       # [Ns, 3] float32  (R(Ps+flow)+t - Ps)
    overlap: np.ndarray       # [Ns] bool (src points with a correspondence)
    rot: np.ndarray           # [3, 3]
    trans: np.ndarray         # [3, 1]
    correspondences: np.ndarray  # [C, 2] int
    name: str = ""
    depth_paths: tuple[str, str] | None = None   # (src, tgt) raw depth maps
    cam_intrin: np.ndarray | None = None         # [3, 3]
    metric_index: np.ndarray | None = None       # 4DLoMatch NRFMR sample ids


class FourDMatchDataset:
    """Sequence of registration pairs from 4DMatch-style npz files."""

    def __init__(self, data_root: str, split: str, max_points: int = 30000,
                 augment: bool = False, augment_noise: float = 0.002,
                 seed: int = 0):
        self.entries = sorted(glob.glob(os.path.join(data_root, split, "*", "*.npz")))
        if not self.entries:
            # also accept flat layout {root}/{split}/*.npz
            self.entries = sorted(glob.glob(os.path.join(data_root, split, "*.npz")))
        self.max_points = max_points
        self.augment = augment
        self.augment_noise = augment_noise
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i: int) -> Pair:
        with np.load(self.entries[i], allow_pickle=True) as z:
            rot = z["rot"].astype(np.float32)
            trans = z["trans"].astype(np.float32).reshape(3, 1)
            s_pc = z["s_pc"].astype(np.float32)
            t_pc = z["t_pc"].astype(np.float32)
            flow = z["s2t_flow"].astype(np.float32)
            corr = z["correspondences"].astype(np.int64)
            # optional raw depth-map paths for the ED/N-ICP path
            # (reference _4dmatch.py:75-89)
            depth_paths = None
            cam_intrin = None
            if "depth_paths" in z.files:
                dp = z["depth_paths"]
                depth_paths = (str(dp[0]), str(dp[1]))
            if "cam_intrin" in z.files:
                cam_intrin = z["cam_intrin"].astype(np.float64)
            metric_index = (z["metric_index"].astype(np.int64)
                            if "metric_index" in z.files else None)

        # random cap at max_points, keeping flow/correspondence alignment
        if len(s_pc) > self.max_points:
            keep = self.rng.permutation(len(s_pc))[: self.max_points]
            remap = np.full(len(s_pc), -1, np.int64)
            remap[keep] = np.arange(len(keep))
            s_pc, flow = s_pc[keep], flow[keep]
            m = remap[corr[:, 0]] >= 0
            corr = np.stack([remap[corr[m, 0]], corr[m, 1]], 1)
            if metric_index is not None:
                mi = remap[metric_index]
                metric_index = mi[mi >= 0]
        if len(t_pc) > self.max_points:
            keep = self.rng.permutation(len(t_pc))[: self.max_points]
            remap = np.full(len(t_pc), -1, np.int64)
            remap[keep] = np.arange(len(keep))
            t_pc = t_pc[keep]
            m = remap[corr[:, 1]] >= 0
            corr = np.stack([corr[m, 0], remap[corr[m, 1]]], 1)

        if self.augment:
            s_pc, t_pc, flow, rot, trans = self._augment(
                s_pc, t_pc, flow, rot, trans)

        # scene-flow GT (eval_nolearned.py:75-78)
        warped = (rot @ (s_pc + flow).T + trans).T
        flow_gt = warped - s_pc
        overlap = np.zeros(len(s_pc), bool)
        overlap[corr[:, 0]] = True
        return Pair(src=s_pc, tgt=t_pc, flow_gt=flow_gt, overlap=overlap,
                    rot=rot, trans=trans, correspondences=corr,
                    name=self.entries[i], depth_paths=depth_paths,
                    cam_intrin=cam_intrin, metric_index=metric_index)

    def _augment(self, s_pc, t_pc, flow, rot, trans):
        """Random SO(3) on src or tgt + noise (``_4dmatch.py:116-131``).

        The deformed source (``s_pc + flow``) rotates WITH the source and
        the flow is recomputed after rotation + noise (reference
        ``_4dmatch.py:121-130``), so the GT identity
        ``R(s_pc + flow) + t = t_pc`` stays exact under augmentation (the
        src noise is absorbed into the flow). The original version rotated
        only ``s_pc`` with an inconsistent ``rot`` update, which made every
        train-time GT inlier label garbage — NeCo trained on those labels
        learned a constant confidence (the round-4 "NeCo filtering is a
        no-op" finding)."""
        euler = self.rng.random(3) * 2 * np.pi
        cx, cy, cz = np.cos(euler)
        sx, sy, sz = np.sin(euler)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        R_ab = (Rx @ Ry @ Rz).astype(np.float32)
        deformed = s_pc + flow
        if self.rng.random() > 0.5:
            s_pc = (R_ab @ s_pc.T).T
            deformed = (R_ab @ deformed.T).T
            rot = rot @ R_ab.T
        else:
            t_pc = (R_ab @ t_pc.T).T
            rot = R_ab @ rot
            trans = R_ab @ trans
        s_pc = s_pc + (self.rng.random(s_pc.shape).astype(np.float32) - 0.5) * self.augment_noise
        t_pc = t_pc + (self.rng.random(t_pc.shape).astype(np.float32) - 0.5) * self.augment_noise
        flow = deformed - s_pc
        return s_pc, t_pc, flow, rot, trans


def _bucket_size(n: int, minimum: int = 1024) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class Batch:
    src: np.ndarray        # [B, N, 3] padded
    tgt: np.ndarray        # [B, M, 3] padded
    src_valid: np.ndarray  # [B, N] bool
    tgt_valid: np.ndarray  # [B, M] bool
    flow_gt: np.ndarray    # [B, N, 3]
    overlap: np.ndarray    # [B, N]
    indices: list[int]     # dataset indices of the pairs
    names: list[str] = dataclasses.field(default_factory=list)  # pair names


class BucketBatcher:
    """Groups pairs into (src_bucket, tgt_bucket) shape buckets of size B.

    One compiled registration program per bucket shape; pairs are emitted in
    dataset order within each bucket, with the last batch of a bucket padded
    by repeating its final pair (mask ``indices`` for metric accounting).
    """

    def __init__(self, dataset, batch_size: int, min_bucket: int = 1024,
                 square: bool = False):
        """``square=True`` pads src and tgt to the SAME bucket size
        (max of the two): compiled-shape count drops from O(k^2) bucket
        combinations to O(k) — each distinct solver shape is a program of its own
        for a compiling caller."""
        self.ds = dataset
        self.b = batch_size
        self.min_bucket = min_bucket
        self.square = square

    def __iter__(self):
        buckets: dict[tuple[int, int], list[tuple[int, Pair]]] = {}
        for i in range(len(self.ds)):
            p = self.ds[i]
            key = (_bucket_size(len(p.src), self.min_bucket),
                   _bucket_size(len(p.tgt), self.min_bucket))
            if self.square:
                key = (max(key), max(key))
            buckets.setdefault(key, []).append((i, p))
            if len(buckets[key]) == self.b:
                yield self._emit(key, buckets.pop(key))
        for key, items in buckets.items():
            while len(items) < self.b:  # pad final partial batch
                items.append(items[-1])
            yield self._emit(key, items)

    def _emit(self, key: tuple[int, int], items) -> Batch:
        n, m = key
        b = len(items)
        src = np.zeros((b, n, 3), np.float32)
        tgt = np.zeros((b, m, 3), np.float32)
        sv = np.zeros((b, n), bool)
        tv = np.zeros((b, m), bool)
        fg = np.zeros((b, n, 3), np.float32)
        ov = np.zeros((b, n), bool)
        idx = []
        names = []
        for j, (i, p) in enumerate(items):
            ns, nt = len(p.src), len(p.tgt)
            src[j, :ns] = p.src
            tgt[j, :nt] = p.tgt
            sv[j, :ns] = True
            tv[j, :nt] = True
            fg[j, :ns] = p.flow_gt
            ov[j, :ns] = p.overlap
            idx.append(i)
            names.append(p.name)
        return Batch(src=src, tgt=tgt, src_valid=sv, tgt_valid=tv,
                     flow_gt=fg, overlap=ov, indices=idx, names=names)
