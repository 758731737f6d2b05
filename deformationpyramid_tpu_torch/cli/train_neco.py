"""Train the NeCo outlier-rejection model (matcher frozen).

Counterpart of ``deformationpyramid_tpu/cli/train_neco.py`` (reference
``correspondence/main.py`` + ``lib/trainer.py``): builds datasets and
collate pyramids on the host, runs the matcher-forward + NeCo-backward step
on the device.

Usage:
  python -m deformationpyramid_tpu_torch.cli.train_neco \
      --config config/LNDP.yaml --data-root /path/to/4dmatch [--epochs N] \
      [--matcher-weights W.npz] [--save-landmark OUT.npz] [--device cuda]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data.collate import (build_pair_pyramid, calibrate_neighborhood_limits,
                            pow2_cap, pyramid_to_device)
from ..data.fourdmatch import FourDMatchDataset
from ..match.backbone import KPFCN_ARCHITECTURE
from ..match.landmark import LandmarkConfig, init_landmark_model
from ..train.trainer import TrainConfig, train_neco
from ..utils.checkpoint import load_pytree, save_pytree
from ..utils.config import load_config
from .train_matcher import landmark_config


def interpolate_flow_to_coarse(coarse_src: np.ndarray, full_src: np.ndarray,
                               flow: np.ndarray, knn: int = 3) -> np.ndarray:
    """kNN inverse-distance flow blending (reference
    ``datasets/utils.py:42-58`` blend_scene_flow)."""
    d = ((coarse_src[:, None] - full_src[None]) ** 2).sum(-1)
    idx = np.argsort(d, axis=1)[:, :knn]
    nd = np.sqrt(np.take_along_axis(d, idx, axis=1))
    w = 1.0 / np.maximum(nd, 1e-10)
    w = w / w.sum(1, keepdims=True)
    return (flow[idx] * w[..., None]).sum(1).astype(np.float32)


def make_batch_stream(ds: FourDMatchDataset, lcfg: LandmarkConfig, limits,
                      device: torch.device | str | None = None):
    """Yield NeCo-training dicts on ``device`` (the GPU unless the caller
    names another), one pair at a time."""
    device = torch.device("cuda" if device is None else device)
    cl = lcfg.matcher.coarse_level

    def stream():
        for i in range(len(ds)):
            pair = ds[i]
            pyr = build_pair_pyramid(pair.src, pair.tgt, lcfg.matcher.kpfcn,
                                     KPFCN_ARCHITECTURE, limits,
                                     pad_to="pow2")
            s_len = pyr.src_lengths[cl]
            # symmetric pow2 coarse cap: the frozen matcher forward other-
            # wise pads both clouds to the full stacked coarse size
            cap = pow2_cap(max(s_len, pyr.tgt_lengths[cl]))
            coarse_src = pyr.points[cl][:s_len]
            cflow = interpolate_flow_to_coarse(coarse_src, pair.src,
                                               pair.flow_gt)
            # flow_gt here is already R(Ps+flow)+t - Ps; the loss wants the
            # deformation-only flow with (rot, trans) applied separately, so
            # recover it: flow_def = R^-1 (flow_gt + Ps - t) - Ps
            flow_def = (pair.rot.T @ (cflow + coarse_src
                                      - pair.trans.T).T).T - coarse_src
            coarse_flow = np.zeros((cap, 3), np.float32)
            coarse_flow[:s_len] = flow_def
            put = lambda a: torch.from_numpy(  # noqa: E731
                np.ascontiguousarray(a)).to(device)
            yield {
                "pyramid": pyramid_to_device(pyr, device),
                "src_len_c": torch.tensor(s_len, dtype=torch.int32,
                                          device=device),
                "tgt_len_c": torch.tensor(pyr.tgt_lengths[cl],
                                          dtype=torch.int32, device=device),
                "coarse_flow": put(coarse_flow),
                "gt_rot": put(pair.rot),
                "gt_trn": put(pair.trans),
                "s_cap": cap,
                "t_cap": cap,
            }

    return stream


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--split", default="train")
    ap.add_argument("--val-split", default=None,
                    help="validation split (default: 'val', or "
                         "'val-<suffix>' when --split is 'train-<suffix>')")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--augment", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="train-time random-SO(3) augmentation (reference "
                         "_4dmatch.py:116-131 applies it on the train "
                         "split; default on, matching the reference). "
                         "train_matcher trains augment-free, so its matcher "
                         "emits mostly-outlier matches on rotated pairs: "
                         "use --no-augment to train NeCo on the match "
                         "distribution it will see at eval.")
    ap.add_argument("--matcher-weights", default=None)
    ap.add_argument("--snapshot-dir", default="snapshot/neco",
                    help="history.jsonl / checkpoint directory (give each "
                         "retrain its own so histories don't interleave)")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--save-landmark", default=None,
                    help="after training, save the combined "
                         "{matcher, neco} landmark-model checkpoint here "
                         "(what landmark_inference takes, through "
                         "load_pytree)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    data_root = args.data_root or cfg.get("data_root")
    lcfg = landmark_config(cfg)
    ds = FourDMatchDataset(data_root, args.split, augment=args.augment)
    if args.limit:
        ds.entries = ds.entries[:args.limit]
    if len(ds) == 0:
        raise SystemExit(f"no training data under {data_root}/{args.split}")
    val_split = args.val_split or args.split.replace("train", "val", 1)

    params = init_landmark_model(torch.Generator().manual_seed(0), lcfg,
                                 device=args.device)
    if args.matcher_weights:
        params["matcher"] = load_pytree(args.matcher_weights,
                                        params["matcher"])

    sample_pairs = [(ds[i].src, ds[i].tgt) for i in range(min(3, len(ds)))]
    limits = calibrate_neighborhood_limits(sample_pairs, lcfg.matcher.kpfcn,
                                           KPFCN_ARCHITECTURE)
    tcfg = TrainConfig(max_epoch=args.epochs,
                       optimizer=cfg.get("optimizer", "SGD"),
                       lr=cfg.get("lr", 0.01),
                       momentum=cfg.get("momentum", 0.9),
                       weight_decay=cfg.get("weight_decay", 1e-6),
                       scheduler=cfg.get("scheduler", "ExpLR"),
                       scheduler_gamma=cfg.get("scheduler_gamma", 0.99),
                       lr_milestones=tuple(cfg.get("lr_milestones", ())),
                       iter_size=cfg.get("iter_size", 1),
                       snapshot_dir=args.snapshot_dir)
    # validation split for best-model selection (reference trainer.py:266-271)
    val_stream = None
    if cfg.get("do_valid", False):
        if val_split == args.split:
            # --split without a 'train' substring: the derived val split
            # would BE the training data, silently invalidating best-model
            # selection
            raise SystemExit(
                f"cannot derive a validation split from --split "
                f"{args.split!r} (no 'train' substring to replace); pass "
                "--val-split explicitly")
        vds = FourDMatchDataset(data_root, val_split, augment=False)
        if args.limit:
            vds.entries = vds.entries[:args.limit]
        if len(vds):
            val_stream = make_batch_stream(vds, lcfg, limits,
                                           device=args.device)
    neco_params = train_neco(
        params["matcher"], params["neco"], lcfg, tcfg,
        make_batch_stream(ds, lcfg, limits, device=args.device),
        steps_per_epoch=len(ds), val_batches=val_stream)
    if args.save_landmark:
        save_pytree(args.save_landmark,
                    {"matcher": params["matcher"], "neco": neco_params})
        print(f"saved combined landmark checkpoint to {args.save_landmark}")


if __name__ == "__main__":
    main()
