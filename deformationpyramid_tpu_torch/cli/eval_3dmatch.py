"""3DMatch rigid-registration evaluation: matcher + RANSAC recall.

Counterpart of ``deformationpyramid_tpu/cli/eval_3dmatch.py``: the
reference ships a 3DMatch dataset (``correspondence/datasets/_3dmatch.py``)
and the RANSAC / transformation-error utilities
(``correspondence/lepard/loss.py:13-43``) but never wires them together.
Here: ``ThreeDMatchDataset`` pairs -> KPConv pyramid -> Lepard matcher
(kernel C7 in every attention layer) + optional NeCo filter -> host
Kabsch-RANSAC -> registration recall at the redwood-data weighted-error
convention, plus IR / RRE / RTE.

Usage:
  python -m deformationpyramid_tpu_torch.cli.eval_3dmatch \\
      --config config/LNDP.yaml --weights snapshot/landmark_trained_3dm.npz \\
      [--info data/split/3DMatch/test_info.npz --base-dir data/split] \\
      [--device cpu]

``--visualize`` writes each pair's correspondence lines under
``<log-dir>/vis/``, coloured by the ground-truth inlier test: an edge PLY
and a PNG (the PNG needs matplotlib).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..data.collate import (build_pair_pyramid, calibrate_neighborhood_limits,
                            pow2_cap, pyramid_to_device)
from ..data.threedmatch import ThreeDMatchDataset
from ..match.backbone import KPFCN_ARCHITECTURE
from ..match.landmark import (LandmarkConfig, init_landmark_model,
                              landmark_inference)
from ..metrics.registration import (ransac_rigid_from_correspondences,
                                    registration_recall, to_transform,
                                    transformation_error)
from ..utils.checkpoint import load_pytree
from ..utils.config import load_config
from ..utils.logging import AverageMeter, Logger, write_run_provenance
from .eval_supervised import COARSE_CAP_MIN, landmark_config


def run_eval_3dmatch(lcfg: LandmarkConfig, params, ds: ThreeDMatchDataset,
                     gt_covs, log_dir: str = "snapshot/threedmatch",
                     ransac_iters: int = 5000, ransac_thr: float = 0.05,
                     recall_thr: float = 0.2 ** 2, seed: int = 0,
                     visualize: bool = False,
                     device: torch.device | str = "cuda") -> dict:
    """Evaluate matcher-driven rigid registration over a 3DMatch dataset.

    Returns the aggregate metrics (registration_recall as ``value``, IR,
    RRE, RTE: the JSON line the log ends with) and, beyond that line, the
    seconds of the matcher and of the host RANSAC (``matcher_s``,
    ``ransac_s``).
    """
    device = torch.device(device)
    os.makedirs(log_dir, exist_ok=True)
    write_run_provenance(log_dir, device=str(device))
    logger = Logger(os.path.join(log_dir, "3DMatch.log"))
    ledger_fw = open(os.path.join(log_dir, "3DMatch.pairs.jsonl"), "a")

    sample_pairs = [(ds[i].src, ds[i].tgt) for i in range(min(3, len(ds)))]
    limits = calibrate_neighborhood_limits(sample_pairs, lcfg.matcher.kpfcn,
                                           KPFCN_ARCHITECTURE)

    meters: dict[str, AverageMeter] = {}
    preds, gts, covs = [], [], []
    matcher_s = ransac_s = 0.0
    t0 = time.perf_counter()
    try:
        for i in range(len(ds)):
            pair = ds[i]
            pyr = build_pair_pyramid(pair.src, pair.tgt, lcfg.matcher.kpfcn,
                                     KPFCN_ARCHITECTURE, limits,
                                     pad_to="pow2")
            cl = lcfg.matcher.coarse_level
            sl, tl = int(pyr.src_lengths[cl]), int(pyr.tgt_lengths[cl])
            cap = pow2_cap(max(sl, tl), COARSE_CAP_MIN)
            t_m = time.perf_counter()
            data = landmark_inference(params, pyramid_to_device(pyr, device),
                                      sl, tl, lcfg, s_cap=cap, t_cap=cap)
            ldmk_valid = data["ldmk_valid"].cpu().numpy().astype(bool)
            matcher_s += time.perf_counter() - t_m
            ldmk_s = data["ldmk_s"].cpu().numpy()[ldmk_valid]
            ldmk_t = data["ldmk_t"].cpu().numpy()[ldmk_valid]

            t_r = time.perf_counter()
            R, t, inl = ransac_rigid_from_correspondences(
                ldmk_s, ldmk_t, n_iters=ransac_iters, inlier_thr=ransac_thr,
                seed=seed + i)
            ransac_s += time.perf_counter() - t_r
            pred_T = to_transform(R, t)
            gt_T = to_transform(pair.rot, pair.trans)
            cov = np.asarray(gt_covs[i], np.float64)
            err = transformation_error(np.linalg.inv(pred_T) @ gt_T, cov)

            # rigid IR: matches within 4 cm of the GT-transformed source
            # (outlier_rejection/loss.py:162-190 with zero flow)
            if len(ldmk_s):
                warped = ldmk_s @ pair.rot.T + pair.trans.reshape(3)
                ir = float(np.mean(np.linalg.norm(warped - ldmk_t, axis=1)
                                   < 0.04))
            else:
                ir = 0.0
            # RRE (deg) / RTE (m): the standard rigid-registration errors
            cos_a = np.clip((np.trace(pair.rot.T @ R) - 1) / 2, -1, 1)
            rre = float(np.degrees(np.arccos(cos_a)))
            rte = float(np.linalg.norm(t - pair.trans.reshape(3)))

            if visualize and len(ldmk_s):
                from ..utils.vis import (export_correspondences_ply,
                                         visualize_correspondences)

                vdir = os.path.join(log_dir, "vis")
                os.makedirs(vdir, exist_ok=True)
                base = os.path.join(
                    vdir, os.path.basename(pair.name).replace("/", "_"))
                gt_inl = np.linalg.norm(warped - ldmk_t, axis=1) < 0.04
                export_correspondences_ply(base + "_corr.ply", ldmk_s,
                                           ldmk_t, inlier=gt_inl)
                visualize_correspondences(ldmk_s, ldmk_t, inlier=gt_inl,
                                          src_pcd=pair.src, tgt_pcd=pair.tgt,
                                          save_path=base + "_corr.png")

            row = {"recall_ok": float(err < recall_thr),
                   "trans_err": float(err), "IR": ir, "RRE_deg": rre,
                   "RTE": rte, "n_matches": float(ldmk_valid.sum()),
                   "ransac_inliers": float(inl.sum())}
            for k, v in row.items():
                meters.setdefault(k, AverageMeter()).update(v)
            ledger_fw.write(json.dumps(dict(row, name=pair.name)) + "\n")
            ledger_fw.flush()
            preds.append(pred_T)
            gts.append(gt_T)
            covs.append(cov)
    finally:
        ledger_fw.close()

    dt = time.perf_counter() - t0
    recall = registration_recall(preds, gts, covs, threshold=recall_thr)
    msg = (f"{len(ds)} pairs: registration_recall: {recall:.3f}\t"
           + "\t".join(f"{k}: {v.avg:.3f}" for k, v in meters.items()))
    logger.write(msg + "\n")
    print("3DMatch eval\n", msg)
    summary = {"metric": "threedmatch_recall", "value": round(recall, 4),
               "pairs": len(ds), "total_s": round(dt, 2),
               "IR": round(meters["IR"].avg, 4),
               "RRE_deg": round(meters["RRE_deg"].avg, 4),
               "RTE": round(meters["RTE"].avg, 4)}
    logger.write(json.dumps(summary) + "\n")
    logger.close()
    print(json.dumps(summary))
    return dict(summary, matcher_s=matcher_s, ransac_s=ransac_s)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--info", default="data/split/3DMatch/test_info.npz")
    ap.add_argument("--base-dir", default="data/split")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--log-dir", default="snapshot/threedmatch")
    ap.add_argument("--ransac-iters", type=int, default=5000)
    ap.add_argument("--ransac-thr", type=float, default=0.05)
    ap.add_argument("--reject-outliers", dest="reject_outliers",
                    action="store_true", default=None)
    ap.add_argument("--no-reject-outliers", dest="reject_outliers",
                    action="store_false")
    ap.add_argument("--visualize", action="store_true",
                    help="save per-pair correspondence-line renders "
                         "(ground-truth-inlier PNG + edge PLY) under "
                         "<log-dir>/vis/")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the landmark model (default cuda)")

    return ap


def main(argv: list[str] | None = None) -> dict:
    """Run the evaluation; returns :func:`run_eval_3dmatch`'s summary."""
    args = build_parser().parse_args(argv)
    cfg = load_config(args.config)
    device = torch.device(args.device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    # as the JAX CLI: the yaml's extraction cap (uncapped in LNDP.yaml)
    lcfg = landmark_config(cfg, args.reject_outliers)
    params = init_landmark_model(torch.Generator().manual_seed(0), lcfg,
                                 device=device)
    if args.weights:
        params = load_pytree(args.weights, params)
    else:
        print("[warn] no --weights: the landmark model of seed 0 "
              "(pipeline validation only)")

    ds = ThreeDMatchDataset(args.info, args.base_dir)
    gt_covs = ds.infos.get("gt_cov")
    if gt_covs is None:
        gt_covs = [np.eye(6)] * len(ds)
    if args.limit is not None:
        ds.infos = {k: v[: args.limit] for k, v in ds.infos.items()}
        gt_covs = gt_covs[: args.limit]
    return run_eval_3dmatch(lcfg, params, ds, gt_covs, log_dir=args.log_dir,
                            ransac_iters=args.ransac_iters,
                            ransac_thr=args.ransac_thr,
                            visualize=args.visualize, device=device)


if __name__ == "__main__":
    main()
