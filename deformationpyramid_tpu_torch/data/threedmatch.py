"""3DMatch rigid-registration dataset.

A copy of ``deformationpyramid_tpu/data/threedmatch.py`` (numpy + pickle):
reference ``correspondence/datasets/_3dmatch.py``. An info pickle (or npz)
lists per-pair rot / trans / src / tgt paths; clouds load from .pth (torch)
or .npy files, cap at max_points, optional SO(3) + noise augmentation,
correspondences = radius matches after applying the GT transform. Rigid
data means s2t_flow == 0 everywhere.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from .correspondence_utils import mutual_nn_correspondence
from .fourdmatch import Pair


def _load_cloud(path: str) -> np.ndarray:
    if path.endswith(".pth") or path.endswith(".pt"):
        import torch

        return np.asarray(torch.load(path, map_location="cpu",
                                     weights_only=False), np.float32)
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z[z.files[0]].astype(np.float32)
    raise ValueError(f"unsupported cloud format: {path}")


class ThreeDMatchDataset:
    """Pairs from a 3DMatch-style info file.

    info: pickle/npz with keys rot [P,3,3], trans [P,3,1], src [P] (paths),
    tgt [P] (paths), optional gt_cov.
    """

    def __init__(self, info_path: str, base_dir: str,
                 max_points: int = 30000, overlap_radius: float = 0.0375,
                 augment: bool = False, augment_noise: float = 0.005,
                 rot_factor: float = 1.0, seed: int = 0):
        if info_path.endswith(".pkl"):
            with open(info_path, "rb") as f:
                self.infos = pickle.load(f)
        else:
            with np.load(info_path, allow_pickle=True) as z:
                self.infos = {k: z[k] for k in z.files}
        self.base_dir = base_dir
        self.max_points = max_points
        self.overlap_radius = overlap_radius
        self.augment = augment
        self.augment_noise = augment_noise
        self.rot_factor = rot_factor
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.infos["rot"])

    def __getitem__(self, i: int) -> Pair:
        rot = np.asarray(self.infos["rot"][i], np.float32)
        trans = np.asarray(self.infos["trans"][i], np.float32).reshape(3, 1)
        src = _load_cloud(os.path.join(self.base_dir,
                                       str(self.infos["src"][i])))
        tgt = _load_cloud(os.path.join(self.base_dir,
                                       str(self.infos["tgt"][i])))
        if len(src) > self.max_points:
            src = src[self.rng.permutation(len(src))[: self.max_points]]
        if len(tgt) > self.max_points:
            tgt = tgt[self.rng.permutation(len(tgt))[: self.max_points]]

        if self.augment:
            euler = self.rng.random(3) * 2 * np.pi / self.rot_factor
            cz, cy, cx = np.cos(euler)
            sz, sy, sx = np.sin(euler)
            Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
            R_ab = (Rz @ Ry @ Rx).astype(np.float32)
            if self.rng.random() > 0.5:
                src = src @ R_ab.T
                rot = rot @ R_ab.T
            else:
                tgt = tgt @ R_ab.T
                rot = R_ab @ rot
                trans = R_ab @ trans
            src = src + (self.rng.random(src.shape).astype(np.float32)
                         - 0.5) * self.augment_noise
            tgt = tgt + (self.rng.random(tgt.shape).astype(np.float32)
                         - 0.5) * self.augment_noise

        warped = (rot @ src.T + trans).T
        corr = mutual_nn_correspondence(warped, tgt,
                                        search_radius=self.overlap_radius)
        flow_gt = warped - src
        overlap = np.zeros(len(src), bool)
        overlap[corr[:, 0]] = True
        return Pair(src=src, tgt=tgt, flow_gt=flow_gt, overlap=overlap,
                    rot=rot, trans=trans, correspondences=corr,
                    name=str(self.infos["src"][i]))
