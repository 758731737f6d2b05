"""Train the Lepard matcher with MatchMotionLoss on a 4DMatch-format suite.

Counterpart of ``deformationpyramid_tpu/cli/train_matcher.py``. The
reference trains its matcher in the upstream Lepard repository and only
ships checkpoints (``correspondence/landmark_estimator.py:33-39``); this
exposes the training surface directly: focal correspondence loss +
rigid-motion loss per positioning layer (``lepard/loss.py:80-188``), coarse
GT matches built like the reference collate
(``datasets/dataloader.py:552-562``: blend the raw scene flow to the coarse
level, GT-warp, mutual-NN within ``coarse_match_radius``).

Usage:
  python -m deformationpyramid_tpu_torch.cli.train_matcher \
      --config config/LNDP.yaml [--data-root data/split] [--epochs 20] \
      [--limit N] [--lr 1e-4] [--device cuda]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.collate import (build_pair_pyramid, calibrate_neighborhood_limits,
                            pow2_cap, pyramid_to_device)
from ..data.correspondence_utils import (blend_scene_flow,
                                         mutual_nn_correspondence)
from ..data.fourdmatch import FourDMatchDataset
from ..match.backbone import KPFCN_ARCHITECTURE
from ..match.landmark import LandmarkConfig, init_landmark_model
from ..train.trainer import TrainConfig, train_matcher
from ..utils.checkpoint import load_pytree
from ..utils.config import load_config


def make_matcher_batch_stream(ds: FourDMatchDataset, lcfg: LandmarkConfig,
                              limits, coarse_match_radius: float = 0.024,
                              cache: bool = True,
                              device: torch.device | str | None = None):
    """Yield matcher-training dicts on ``device`` (the GPU unless the caller
    names another), one pair at a time.

    Every pair carries static power-of-two ``s_cap``/``t_cap`` (symmetric),
    the JAX package's buckets, so the two packages' batches compare array
    for array.

    ``cache=True`` keeps the collated device batches across epochs: with
    ``augment=False`` the pyramids are deterministic, and collating again
    is single-core host work far longer than the step it feeds.
    """
    device = torch.device("cuda" if device is None else device)
    cl = lcfg.matcher.coarse_level
    cached: list[dict] = []

    def build(i):
        pair = ds[i]
        pyr = build_pair_pyramid(pair.src, pair.tgt, lcfg.matcher.kpfcn,
                                 KPFCN_ARCHITECTURE, limits, pad_to="pow2")
        s_len = pyr.src_lengths[cl]
        t_len = pyr.tgt_lengths[cl]
        cap = pow2_cap(max(s_len, t_len))
        coarse = pyr.points[cl]
        c_src = coarse[:s_len]
        c_tgt = coarse[s_len:s_len + t_len]
        # deformation-only flow (flow_gt stores the composed motion):
        # flow_def = R^-1 (flow_gt + Ps - t) - Ps, blended coarse like the
        # reference (sflow_list is the raw flow, dataloader.py:557)
        flow_def = (pair.rot.T @ (pair.flow_gt + pair.src
                                  - pair.trans.T).T).T - pair.src
        c_flow = blend_scene_flow(c_src, pair.src,
                                  flow_def.astype(np.float32))
        warped = (pair.rot @ (c_src + c_flow).T + pair.trans).T
        corr = mutual_nn_correspondence(warped, c_tgt,
                                        search_radius=coarse_match_radius)
        match_gt = np.zeros((cap, 2), np.int64)
        match_gt_valid = np.zeros((cap,), bool)
        m = min(len(corr), cap)
        match_gt[:m] = corr[:m]
        match_gt_valid[:m] = True
        coarse_flow = np.zeros((cap, 3), np.float32)
        coarse_flow[:s_len] = c_flow
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        return {
            "pyramid": pyramid_to_device(pyr, device),
            "src_len_c": torch.tensor(s_len, dtype=torch.int32, device=device),
            "tgt_len_c": torch.tensor(t_len, dtype=torch.int32, device=device),
            "match_gt": put(match_gt),
            "match_gt_valid": put(match_gt_valid),
            "coarse_flow": put(coarse_flow),
            "gt_rot": put(pair.rot),
            "gt_trn": put(pair.trans),
            "s_cap": cap,
            "t_cap": cap,
        }

    def stream():
        if cache and cached:
            yield from cached
            return
        for i in range(len(ds)):
            b = build(i)
            if cache:
                cached.append(b)
            yield b

    return stream


def landmark_config(cfg) -> LandmarkConfig:
    """The landmark model's configuration that a top-level config names
    (``ldmk_config``), or the defaults where it names none."""
    ldmk_yaml = cfg.get("ldmk_config")
    if ldmk_yaml and os.path.exists(ldmk_yaml):
        from ..match.config_loader import landmark_config_from_yaml

        return landmark_config_from_yaml(ldmk_yaml)
    return LandmarkConfig()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--split", default="train")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--resume-weights", default=None,
                    help="matcher npz to continue from")
    ap.add_argument("--snapshot-dir", default="snapshot/matcher")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = load_config(args.config)
    data_root = args.data_root or cfg.get("data_root")
    ldmk_yaml = cfg.get("ldmk_config")
    lcfg = landmark_config(cfg)
    ds = FourDMatchDataset(data_root, args.split, augment=False)
    if args.limit:
        ds.entries = ds.entries[: args.limit]
    if len(ds) == 0:
        raise SystemExit(f"no training data under {data_root}/{args.split}")

    params = init_landmark_model(torch.Generator().manual_seed(0), lcfg,
                                 device=args.device)
    matcher_params = params["matcher"]
    if args.resume_weights:
        matcher_params = load_pytree(args.resume_weights, matcher_params)

    sample_pairs = [(ds[i].src, ds[i].tgt) for i in range(min(3, len(ds)))]
    limits = calibrate_neighborhood_limits(sample_pairs, lcfg.matcher.kpfcn,
                                           KPFCN_ARCHITECTURE)
    tcfg = TrainConfig(max_epoch=args.epochs, optimizer="Adam", lr=args.lr,
                       weight_decay=cfg.get("weight_decay", 1e-6),
                       scheduler="ExpLR",
                       scheduler_gamma=cfg.get("scheduler_gamma", 0.99),
                       snapshot_dir=args.snapshot_dir)
    # the JAX package's lookup, key for key (the yaml keeps the radius under
    # kpfcn_config, so this is the default today)
    radius = 0.024
    if ldmk_yaml and os.path.exists(ldmk_yaml):
        lepard_yaml = load_config(load_config(ldmk_yaml).matcher_config)
        radius = lepard_yaml.coarse_matching.get("coarse_match_radius",
                                                 radius)
    train_matcher(matcher_params, lcfg, tcfg,
                  make_matcher_batch_stream(ds, lcfg, limits, radius,
                                            device=args.device),
                  steps_per_epoch=len(ds))


if __name__ == "__main__":
    main()
