"""4DMatch multiview dataset: per-sequence clouds + pairwise flows.

A copy of ``deformationpyramid_tpu/data/fourdmatch_multiview.py`` (numpy
only; reference ``correspondence/datasets/_4dmatch_multiview.py:61-100``):
npz per sequence with fields pcds / pcd_pairs / pairwise_flows /
pairwise_overlap / _2axis_flow / axis_node / poses; pairs filtered by a
two-sided overlap threshold. GT convention R(Ps+flow)+t = Pt.
"""
from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np


@dataclasses.dataclass
class MultiviewSample:
    pcds: np.ndarray             # [V, N, 3] per-view clouds
    pcd_pairs: np.ndarray        # [P, 2] view index pairs (filtered)
    pairwise_flows: np.ndarray   # [P, N, 3]
    pairwise_overlap: np.ndarray # [P, 2]
    axis_flow: np.ndarray        # _2axis_flow
    axis_node: np.ndarray
    poses: np.ndarray            # [V, 4, 4]


class FourDMatchMultiview:
    def __init__(self, data_root: str, split: str,
                 overlap_threshold: float = 0.4, cache_size: int = 8):
        self.entries = sorted(
            glob.glob(os.path.join(data_root, split, "*.npz")) +
            glob.glob(os.path.join(data_root, split, "*", "*.npz")))
        self.overlap_threshold = overlap_threshold
        self.cache: dict[int, dict] = {}
        self.cache_size = cache_size

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, index: int) -> MultiviewSample:
        if index in self.cache:
            e = self.cache[index]
        else:
            with np.load(self.entries[index], allow_pickle=True) as z:
                e = {k: z[k] for k in z.files}
            if len(self.cache) < self.cache_size:
                self.cache[index] = e
        overlap = e["pairwise_overlap"]
        valid = (overlap[:, 0] > self.overlap_threshold) & \
                (overlap[:, 1] > self.overlap_threshold)
        return MultiviewSample(
            pcds=e["pcds"],
            pcd_pairs=e["pcd_pairs"][valid],
            pairwise_flows=e["pairwise_flows"][valid],
            pairwise_overlap=overlap[valid],
            axis_flow=e.get("_2axis_flow", np.zeros(0)),
            axis_node=e.get("axis_node", np.zeros(0)),
            poses=e["poses"])
