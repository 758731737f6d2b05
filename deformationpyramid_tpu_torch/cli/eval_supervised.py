"""LNDP supervised evaluation: learned landmarks guiding NDP registration.

Counterpart of ``deformationpyramid_tpu/cli/eval_supervised.py`` (the
reference program ``eval_supervised.py``): for each pair, build the KPConv
pyramid (host), run the Lepard matcher and NeCo outlier rejection
(``match/landmark.py``, kernel C7 in every attention layer), hand the
surviving landmark pairs to the landmark-mode NDP solver (kernel C5 an
iteration with ``w_cd == 0``, C2 -> C1 -> C6 -> C3 -> C4 with ``--w-cd``
> 0) and score the scene flow, with the matcher's IR / NRFMR beside it.

Usage:
  python -m deformationpyramid_tpu_torch.cli.eval_supervised \\
      --config config/LNDP.yaml [--weights snapshot/landmark.npz] \\
      [--data-root data/split] [--limit N] [--device cpu]

Without --weights the landmark model runs with the weights of seed 0
(pipeline validation only). The per-split ledgers (``<split>.log``,
``.pairs.jsonl``, ``.done``) have the JAX package's format.
``--visualize`` writes each pair's correspondence lines under
``<log-dir>/vis/``: a PNG coloured by NeCo's confidence (needs matplotlib)
and an edge PLY coloured by the ground-truth inlier test.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..data.collate import (build_pair_pyramid, calibrate_neighborhood_limits,
                            pow2_cap, pyramid_to_device)
from ..data.correspondence_utils import SceneFlowInterp
from ..data.fourdmatch import FourDMatchDataset
from ..match.backbone import KPFCN_ARCHITECTURE
from ..match.landmark import (LandmarkConfig, init_landmark_model,
                              landmark_inference, matcher_inference,
                              neco_filter)
from ..metrics.matching import inlier_ratio, nrfmr
from ..models.pyramid import NDPConfig, init_pyramid_params
from ..solve.registration import SolverConfig, register_pair
from ..utils.checkpoint import load_pytree
from ..utils.config import load_config
from ..utils.logging import AverageMeter, Logger, write_run_provenance
from ..utils.reporting import split_summary
from ..utils.timers import Timers
from .eval_nolearned import (METRIC_KEYS, _fused_iter_default, metric_vector,
                             pair_id, pair_seed)
from .train_matcher import with_flash

Tensor = torch.Tensor

# Shape buckets: as in the JAX sweep, every level of the KPConv pyramid pads
# to a power of two (``collate_one``), the coarse caps of the matcher double
# from 512 and the solver's clouds from 1024, so that the matcher and its
# attention kernel see the JAX package's shapes.
COARSE_CAP_MIN = 512
SOLVER_BUCKET_MIN = 1024


def make_flow_interp(pair) -> SceneFlowInterp:
    """Deformation-only flow interpolator of a pair: the kNN-IDW blend of
    the per-point flow with the rigid part taken out (the IR definition
    wants R(Ps + flow) + t against ldmk_t, and flow_gt stores the composed
    motion). One anchor cKDTree serves both query sets of the harvest."""
    # flow_def = R^-1 (flow_gt + Ps - t) - Ps
    flow_def = (pair.rot.T @ (pair.flow_gt + pair.src
                              - pair.trans.T).T).T - pair.src
    return SceneFlowInterp(pair.src, flow_def.astype(np.float32))


def interp_flow(query_pts: np.ndarray, pair) -> np.ndarray:
    """One-shot :func:`make_flow_interp`."""
    return make_flow_interp(pair)(query_pts)


def gt_inlier_keep(v6: np.ndarray, mask: np.ndarray, pair) -> np.ndarray:
    """Ground-truth inlier mask over raw matches (reference
    ``outlier_rejection/loss.py:162-190`` compute_inlier_mask): inlier iff
    ||R(s + flow_def(s)) + t - t_match|| < 0.04."""
    flow = interp_flow(np.ascontiguousarray(v6[:, :3]), pair)
    warped = (pair.rot @ (v6[:, :3] + flow).T + pair.trans).T
    d2 = np.sum((warped - v6[:, 3:]) ** 2, axis=1)
    return mask & (d2 < 0.04 ** 2)


def initial_params(scfg: SolverConfig, seed: int,
                   device: torch.device | str | None = None) -> dict:
    """The initial pyramid of one pair's solve, from its seed."""
    return init_pyramid_params(torch.Generator().manual_seed(int(seed)),
                               scfg.pyramid, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pad_rows(a: np.ndarray, rows: int, dtype) -> np.ndarray:
    out = np.zeros((rows,) + a.shape[1:], dtype)
    out[: len(a)] = a
    return out


def write_correspondence_vis(log_dir: str, pair, ldmk_s: np.ndarray,
                             ldmk_t: np.ndarray, confidence: np.ndarray,
                             inlier: np.ndarray) -> None:
    """``<log_dir>/vis/<pair>_corr.ply`` (the edges coloured by ``inlier``)
    and ``_corr.png`` (coloured by ``confidence``, over the two clouds).
    The PLY is written first: it needs no matplotlib."""
    from ..utils.vis import (export_correspondences_ply,
                             visualize_correspondences)

    vdir = os.path.join(log_dir, "vis")
    os.makedirs(vdir, exist_ok=True)
    base = os.path.join(vdir, pair.name.replace("/", "_"))
    export_correspondences_ply(base + "_corr.ply", ldmk_s, ldmk_t,
                               inlier=inlier)
    visualize_correspondences(ldmk_s, ldmk_t, confidence=confidence,
                              src_pcd=pair.src, tgt_pcd=pair.tgt,
                              save_path=base + "_corr.png")


def run_eval(cfg, lcfg: LandmarkConfig, params, scfg: SolverConfig,
             splits, batch_limit=None, seed=0, log_dir="snapshot/lndp",
             stream_depth: int = 4, resume: bool = False,
             stage_timers: bool = False, oracle_filter: bool = False,
             visualize: bool = False,
             device: torch.device | str = "cuda") -> dict[str, dict]:
    """Sweep the splits under ``cfg.data_root``. Returns, per split that
    had data, ``{"scores": {metric: mean over the pairs done, recovered
    ones included}, "pairs": pairs solved in this run, "seconds": their
    wall time, "iters": {pair name: the solver's iterations per level},
    "summary": the lndp_suite JSON line or None}``.

    Each pair's solve is seeded by ``eval_nolearned.pair_seed`` of its file
    name and ``seed``, so that a resumed sweep seeds a pair as the first
    run did; its initial pyramid comes from :func:`initial_params`.
    """
    device = torch.device(device)
    timers = Timers()
    write_run_provenance(log_dir, device=str(device))
    split_stages = stage_timers or oracle_filter

    def _rtt_ms() -> float:
        """The round trip of an empty ``torch.cuda.synchronize()`` (0.0 on
        the CPU): the JAX sweep probes its device link at the same two
        points, so the ledgers keep its rtt_pre / rtt_post columns."""
        if device.type != "cuda":
            return 0.0
        t0 = time.perf_counter()
        torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) * 1e3

    report: dict[str, dict] = {}
    for split in splits:
        ds = FourDMatchDataset(cfg.data_root, split)
        if len(ds) == 0:
            print(f"[skip] no data for split {split} under {cfg.data_root}")
            continue
        if batch_limit is not None:
            ds.entries = ds.entries[:batch_limit]
        n_total = len(ds)
        logger = Logger(os.path.join(log_dir, split + ".log"))
        meters: dict[str, AverageMeter] = {}
        n_done = 0
        stamps: list[float] = []   # harvest times -> per-pair summary
        stages_acc: dict[str, list[float]] = {}  # --stage-timers ms lists
        iters_done: dict[str, list[int]] = {}

        # Resume: the .pairs.jsonl ledger records every finished pair's
        # metrics, so a resumed sweep both skips finished pairs and
        # recovers their share of the final means.
        done_path = os.path.join(log_dir, split + ".done")
        ledger_path = os.path.join(log_dir, split + ".pairs.jsonl")
        if resume and os.path.exists(done_path):
            with open(done_path) as f:
                finished = set(f.read().split())
            before = len(ds.entries)
            ds.entries = [e for e in ds.entries if e not in finished]
            print(f"[resume] {before - len(ds.entries)} pairs already done")
            if os.path.exists(ledger_path):
                recovered = set()
                with open(ledger_path) as f:
                    for line in f:
                        row = json.loads(line)
                        name = row.pop("name", None)
                        if name in finished and name not in recovered:
                            recovered.add(name)
                            for k2, v in row.items():
                                if isinstance(v, (int, float)):
                                    meters.setdefault(
                                        k2, AverageMeter()).update(v)
                n_done = len(recovered)
        n_recovered = n_done
        done_fw = open(done_path, "a")
        ledger_fw = open(ledger_path, "a")

        # neighbourhood limits from a few pairs (reference dataloader.py:609)
        sample_pairs = [(ds[i].src, ds[i].tgt)
                        for i in range(min(3, len(ds)))]
        limits = calibrate_neighborhood_limits(
            sample_pairs, lcfg.matcher.kpfcn, KPFCN_ARCHITECTURE)

        def collate_one(i):
            pair = ds[i]
            pyr = build_pair_pyramid(pair.src, pair.tgt, lcfg.matcher.kpfcn,
                                     KPFCN_ARCHITECTURE, limits,
                                     pad_to="pow2")
            return pair, pyr

        def dispatch(pair, pyr):
            """Enqueue matcher + landmark-guided solve for one pair; the
            metric vector stays on the device. --stage-timers and
            --oracle-filter synchronise between the stages."""
            stage: dict[str, float] = {}
            pyrd = pyramid_to_device(pyr, device)
            cl = lcfg.matcher.coarse_level
            sl, tl = int(pyr.src_lengths[cl]), int(pyr.tgt_lengths[cl])
            # the symmetric power-of-two cap of the JAX sweep
            cap = pow2_cap(max(sl, tl), COARSE_CAP_MIN)
            if split_stages:
                if stage_timers:
                    stage["rtt_pre"] = _rtt_ms()
                t0 = time.perf_counter()
                data = matcher_inference(params, pyrd, sl, tl, lcfg,
                                         s_cap=cap, t_cap=cap)
                if stage_timers:
                    _sync(device)
                    stage["matcher"] = (time.perf_counter() - t0) * 1e3
                if oracle_filter:
                    t0 = time.perf_counter()
                    v6 = data["vec_6d"].cpu().numpy()
                    mask = data["vec_6d_mask"].cpu().numpy().astype(bool)
                    keep = gt_inlier_keep(v6, mask, pair)
                    vec6d = np.where(keep[:, None], v6, 0.0).astype(
                        np.float32)
                    data = dict(
                        data,
                        neco_confidence=torch.from_numpy(
                            keep.astype(np.float32)).to(device),
                        ldmk_s=torch.from_numpy(
                            np.ascontiguousarray(vec6d[:, :3])).to(device),
                        ldmk_t=torch.from_numpy(
                            np.ascontiguousarray(vec6d[:, 3:])).to(device),
                        ldmk_valid=torch.from_numpy(keep).to(device))
                    if stage_timers:
                        stage["oracle"] = (time.perf_counter() - t0) * 1e3
                else:
                    t0 = time.perf_counter()
                    data = neco_filter(params, data, lcfg)
                    if stage_timers:
                        _sync(device)
                        stage["neco"] = (time.perf_counter() - t0) * 1e3
            else:
                data = landmark_inference(params, pyrd, sl, tl, lcfg,
                                          s_cap=cap, t_cap=cap)
            # the solver's buckets: powers of two from 1024
            ns, nt = len(pair.src), len(pair.tgt)
            nb = pow2_cap(ns, SOLVER_BUCKET_MIN)
            mb = pow2_cap(nt, SOLVER_BUCKET_MIN)

            def dev(a):
                return torch.from_numpy(a).to(device)

            src = dev(_pad_rows(pair.src, nb, np.float32))
            tgt = dev(_pad_rows(pair.tgt, mb, np.float32))
            sv = dev(_pad_rows(np.ones(ns, bool), nb, bool))
            tv = dev(_pad_rows(np.ones(nt, bool), mb, bool))
            fg = dev(_pad_rows(pair.flow_gt, nb, np.float32))
            ov = dev(_pad_rows(pair.overlap, nb, bool))
            pseed = pair_seed(pair_id(pair.name), seed)
            t0 = time.perf_counter()
            # one solve + metrics: a [12] metric vector, with the solver's
            # iteration counts appended, is all that crosses to the host
            warped, stats = register_pair(
                pseed, src, tgt, scfg, src_valid=sv, tgt_valid=tv,
                src_ldmk=data["ldmk_s"], tgt_ldmk=data["ldmk_t"],
                ldmk_valid=data["ldmk_valid"],
                params=initial_params(scfg, pseed, device))
            with torch.no_grad():
                mvec = torch.cat([metric_vector(warped - src, fg, ov, sv),
                                  stats["iters"].reshape(-1).to(
                                      torch.float32)])
            if stage_timers:
                _sync(device)
                stage["solve"] = (time.perf_counter() - t0) * 1e3
                stage["rtt_post"] = _rtt_ms()
            return pair, data, mvec, stage

        def harvest(item):
            nonlocal n_done
            pair, data, mvec, stage = item
            t_h = time.perf_counter()
            vals = mvec.cpu().numpy()          # the one fetch of the solve
            m = dict(zip(METRIC_KEYS, (float(v) for v in vals)))
            iters_done[pair.name] = [int(v) for v in vals[len(METRIC_KEYS):]]
            ldmk_s = data["ldmk_s"].cpu()
            ldmk_t = data["ldmk_t"].cpu()
            ldmk_valid = data["ldmk_valid"].cpu()
            rot = torch.from_numpy(np.asarray(pair.rot, np.float32))
            trn = torch.from_numpy(np.asarray(pair.trans, np.float32))
            interp = make_flow_interp(pair)  # one cKDTree, two query sets
            m["n_landmarks"] = float(ldmk_valid.sum())
            # matcher-side metrics on the host: IR @ 0.04 m on the landmark
            # pairs; NRFMR over the metric-index sample (4DLoMatch) or the
            # overlap
            ldmk_flow_gt = interp(ldmk_s.numpy())
            m["IR"] = float(inlier_ratio(
                ldmk_s, ldmk_t, ldmk_valid, rot, trn,
                torch.from_numpy(ldmk_flow_gt)))
            # pre-NeCo IR over the raw mutual-max match set (reference
            # outlier_rejection/loss.py:30-60): IR - IR_pre is NeCo's effect
            v6 = data["vec_6d"].cpu().numpy()
            v6_mask = data["vec_6d_mask"].cpu()
            v6_s = np.ascontiguousarray(v6[:, :3])
            m["n_matches_pre"] = float(v6_mask.sum())
            m["IR_pre"] = float(inlier_ratio(
                torch.from_numpy(v6_s),
                torch.from_numpy(np.ascontiguousarray(v6[:, 3:])), v6_mask,
                rot, trn, torch.from_numpy(interp(v6_s))))
            if pair.metric_index is not None and len(pair.metric_index):
                mi = pair.metric_index
            else:
                mi = np.nonzero(pair.overlap)[0][:1000]
            if len(mi):
                m["NRFMR"] = float(nrfmr(
                    ldmk_s, ldmk_t, ldmk_valid,
                    torch.from_numpy(np.ascontiguousarray(pair.src[mi])),
                    torch.from_numpy(np.ascontiguousarray(
                        pair.flow_gt[mi]))))
            if visualize and bool(ldmk_valid.any()):
                # correspondence lines: NeCo-confidence PNG and ground-truth
                # inlier edge PLY (reference utils/vis.py correspondence
                # toggles), as the JAX CLI writes them
                sel = ldmk_valid.numpy().astype(bool)
                s_np, t_np = ldmk_s.numpy()[sel], ldmk_t.numpy()[sel]
                warped = ((pair.rot @ (s_np + ldmk_flow_gt[sel]).T).T
                          + pair.trans.reshape(3))
                inl = np.linalg.norm(warped - t_np, axis=1) < 0.04
                write_correspondence_vis(
                    log_dir, pair, s_np, t_np,
                    data["neco_confidence"].cpu().numpy()[sel], inl)
            row = {k2: float(v) for k2, v in m.items()}
            for k2, v in row.items():
                meters.setdefault(k2, AverageMeter()).update(v)
            n_done += 1
            extra = {}
            if stage:
                stage["metrics"] = (time.perf_counter() - t_h) * 1e3
                for k2, v in stage.items():
                    stages_acc.setdefault(k2, []).append(v)
                extra["stages_ms"] = {k2: round(v, 2)
                                      for k2, v in stage.items()}
            ledger_fw.write(json.dumps(dict(row, name=pair.name, **extra))
                            + "\n")
            ledger_fw.flush()
            done_fw.write(pair.name + "\n")
            done_fw.flush()
            stamps.append(time.perf_counter())

        # pipelined sweep: collate runs one pair ahead in a worker thread,
        # dispatches run ``stream_depth`` pairs ahead of the harvest
        t_split = time.perf_counter()
        stamps.append(t_split)
        try:
            with ThreadPoolExecutor(1) as pool:
                fut = pool.submit(collate_one, 0) if len(ds) else None
                pending: list = []
                for i in range(len(ds)):
                    timers.tic("collate")
                    pair, pyr = fut.result()
                    if i + 1 < len(ds):
                        fut = pool.submit(collate_one, i + 1)
                    timers.toc("collate")
                    timers.tic("dispatch")
                    pending.append(dispatch(pair, pyr))
                    timers.toc("dispatch")
                    if len(pending) > stream_depth:
                        harvest(pending.pop(0))
                while pending:
                    harvest(pending.pop(0))
        finally:
            done_fw.close()
            ledger_fw.close()
        dt = time.perf_counter() - t_split
        summary = None
        if len(ds):
            print(f"[{split}] {len(ds)} pairs in {dt:.1f}s "
                  f"= {len(ds) / dt:.2f} pairs/s")
            summary = split_summary("lndp_suite", split, stamps,
                                    len(ds), dt, stages_ms=stages_acc)
            print(summary)
            logger.write(summary + "\n")
        msg = f"{n_done}/{n_total} pairs: " + "\t".join(
            f"{k}: {v.avg:.3f}" for k, v in meters.items())
        logger.write(msg + "\n")
        logger.close()
        print("score on", split, "\n", msg)
        report[split] = {"scores": {k: v.avg for k, v in meters.items()},
                         "pairs": n_done - n_recovered, "seconds": dt,
                         "iters": iters_done, "summary": summary}

    print("time cost average")
    for line in timers.get_strings():
        print(line)
    return report


def landmark_config(cfg, reject_outliers: bool | None = None,
                    inlier_thr: float | None = None,
                    max_matches: int | None = None) -> LandmarkConfig:
    """The landmark model of a top-level yaml (``ldmk_config``), with the
    threshold, the rejection switch and the extraction cap from the yaml
    unless given, and the attention on kernel C7 (the yaml's route is
    einsum, as in the JAX package). ``max_matches`` None or 0 is the
    uncapped extraction."""
    reject = (reject_outliers if reject_outliers is not None
              else cfg.get("reject_outliers", True))
    thr = inlier_thr if inlier_thr is not None else cfg.get("inlier_thr",
                                                            0.3)
    cap = (max_matches if max_matches is not None
           else cfg.get("max_matches")) or None
    ldmk_yaml = cfg.get("ldmk_config")
    if ldmk_yaml and os.path.exists(ldmk_yaml):
        from ..match.config_loader import landmark_config_from_yaml

        return with_flash(landmark_config_from_yaml(
            ldmk_yaml, inlier_thr=thr, reject_outliers=reject,
            max_matches=cap))
    return with_flash(LandmarkConfig(inlier_thr=thr, reject_outliers=reject))


def solver_config(cfg, device: torch.device | str,
                  w_cd: float | None = None) -> SolverConfig:
    """config/LNDP.yaml's solver. On CUDA (or with ``use_fused_iteration``
    / ``DP_FUSED_ITER``) the fused routes: kernel C5 an iteration where
    ``w_cd == 0``, C2 -> C1 -> C6 -> C3 -> C4 with the landmark term where
    ``w_cd > 0``."""
    fused = _fused_iter_default(cfg, torch.device(device))
    return SolverConfig(
        pyramid=NDPConfig(m=cfg.get("m", 10), k0=cfg.get("k0", -8),
                          depth=cfg.get("depth", 3),
                          width=cfg.get("width", 128),
                          rotation_format=cfg.get("rotation_format",
                                                  "axis_angle"),
                          motion=cfg.get("motion_type", "SE3")),
        iters=cfg.get("iters", 500), lr=cfg.get("lr", 0.01),
        max_break_count=cfg.get("max_break_count", 15),
        break_threshold_ratio=cfg.get("break_threshold_ratio", 0.001),
        samples=cfg.get("samples", 2000),
        w_ldmk=float(cfg.get("w_ldmk", 0.0)),
        w_cd=w_cd if w_cd is not None else cfg.get("w_cd", 0.0),
        trunc_cd=cfg.get("trunc_cd", 0.25),
        use_fused_iteration=fused, use_fused_ldmk=fused)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--weights", default=None,
                    help="npz checkpoint of the landmark model")
    ap.add_argument("--splits", nargs="*", default=["4DMatch-F",
                                                    "4DLoMatch-F"])
    ap.add_argument("--data-root", default=None,
                    help="override the yaml's data_root")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and the solves "
                         "(default cuda)")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--depth", type=int, default=4,
                    help="pairs dispatched ahead of the harvest "
                         "(0 = synchronous)")
    ap.add_argument("--resume", action="store_true",
                    help="skip pairs already recorded in the split's .done "
                         "ledger and recover their metric contributions")
    ap.add_argument("--log-dir", default="snapshot/lndp",
                    help="snapshot directory for logs / ledgers")
    ap.add_argument("--max-matches", type=int, default=None,
                    help="override the extraction capacity (0/unset = "
                         "uncapped reference semantics)")
    ap.add_argument("--w-cd", type=float, default=None,
                    help="override the chamfer weight in the landmark-mode "
                         "solver objective (reference registration.py:"
                         "187-203; config/LNDP.yaml ships w_cd=0)")
    ap.add_argument("--reject-outliers", dest="reject_outliers",
                    action="store_true", default=None,
                    help="force NeCo outlier rejection on")
    ap.add_argument("--no-reject-outliers", dest="reject_outliers",
                    action="store_false",
                    help="force NeCo outlier rejection off")
    ap.add_argument("--inlier-thr", type=float, default=None,
                    help="override the NeCo confidence threshold "
                         "(reference landmark_estimator.py:63-72, 0.3)")
    ap.add_argument("--oracle-filter", action="store_true",
                    help="replace NeCo with the ground-truth inlier filter "
                         "(outlier_rejection/loss.py:162-190 at 4 cm): the "
                         "outlier rejection's ceiling (uses the ground truth)")
    ap.add_argument("--visualize", action="store_true",
                    help="save per-pair correspondence-line renders "
                         "(NeCo-confidence PNG + ground-truth-inlier edge "
                         "PLY) under <log-dir>/vis/")
    ap.add_argument("--stage-timers", action="store_true",
                    help="synchronise between the matcher, NeCo and solver "
                         "stages and record each pair's ms per stage (slower "
                         "than the pipelined default)")
    return ap


def main(argv: list[str] | None = None) -> dict[str, dict]:
    """Run the sweep; returns :func:`run_eval`'s report."""
    args = build_parser().parse_args(argv)
    cfg = load_config(args.config)
    if args.data_root is not None:
        cfg["data_root"] = args.data_root
    device = torch.device(args.device)
    if device.type == "cuda":
        # the kernels launch on the current device: make it the one asked for
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    reject = args.reject_outliers
    if args.oracle_filter:
        reject = False   # NeCo never filters; the ground truth does
    lcfg = landmark_config(cfg, reject, args.inlier_thr, args.max_matches)
    scfg = solver_config(cfg, device, args.w_cd)
    params = init_landmark_model(torch.Generator().manual_seed(0), lcfg,
                                 device=device)
    if args.weights:
        params = load_pytree(args.weights, params)
    else:
        print("[warn] no --weights: running with the landmark model of "
              "seed 0 (pipeline validation only)")
    return run_eval(cfg, lcfg, params, scfg, args.splits, args.limit,
                    stream_depth=args.depth,
                    resume=args.resume, log_dir=args.log_dir,
                    stage_timers=args.stage_timers,
                    oracle_filter=args.oracle_filter,
                    visualize=args.visualize, device=device)


if __name__ == "__main__":
    main()
