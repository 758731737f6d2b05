#!/usr/bin/env python3
"""The learning recipe of docs/LEARNING.md, end to end with the port's CLIs.

    python3 scripts/learning_torch.py [--data data/split]
        [--ckpt build/learning/ckpt] [--out build/learning/out]
        [--device cuda] [--quick] [--stages NAME ...]

Stages, in order (each prints its seconds; ``--stages`` runs a subset, and
a stage reads the checkpoints earlier stages wrote under ``--ckpt``):

  fabricate        the splits of scripts/make_suites.py that the recipe
                   reads: train (32 pairs, size_clusters (6000,), seed 7),
                   val (8, seed 71), 4DMatch-F (100), 4DLoMatch-F (100,
                   partial 0.40, seed 1), train-3dm-b / val-3dm-b /
                   train-3dm-c (write_3dmatch_train_suite, seeds 24 / 25 /
                   26) and 3DMatch (20 fragment pairs, seed 23);
  untrained_24     eval_supervised, the landmark model of seed 0, on the
                   first 24 pairs of 4DMatch-F;
  train_matcher    train_matcher, 20 epochs at lr 1e-4 on train;
  train_neco       train_neco, 8 epochs on the best matcher, saving the
                   combined checkpoint;
  trained_24       eval_supervised with it on the first 24 pairs of
                   4DMatch-F, then trained_100 on all of them and
                   trained_lo on 4DLoMatch-F;
  stage_timers     eval_supervised --stage-timers on 8 pairs of 4DMatch-F:
                   matcher, NeCo and solve ms a pair, solve ms/iter, with
                   the trained stack's landmark counts;
  c5               kernel C5 alone (chip_smoke.ldmk_case: against its plain
                   version, then CUDA-event times) at the landmark rows and
                   valid count the trained stack gives;
  ft_matcher_3dmb  train_matcher on train-3dm-b, 16 epochs at lr 3e-5 from
                   the best matcher (scripts/onchip_r5_3dm.sh:40-52);
  train_neco_3dmb  train_neco on train-3dm-c, --no-augment, 8 epochs;
  eval_3dmatch     eval_3dmatch on the 20 fragment pairs, with NeCo and
                   with --no-reject-outliers;
  bench            bench_lndp_torch.py on the trained checkpoint (25
                   pairs, 3 repetitions);
  untrained_100    eval_supervised, the model of seed 0, on all 100 pairs;
  targets          the JAX package's trained ledger (JAX_LEDGER) on the
                   same pair names as trained_24 / trained_100, beside
                   them (needs no device: ``--stages targets --out DIR``
                   reads the ledgers a run left in DIR).

Ledgers, logs and training histories go to ``--out``; checkpoints (~150
MB each) to ``--ckpt``. The last line is one JSON object with every
stage's seconds and results and the card's name and power limit.
``--quick`` cuts every split to a few pairs and every training to one
epoch: a rehearsal of the script, not of the recipe (``--device cpu`` runs
it on the CPU at the published widths, slowly).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CONFIG = os.path.join(REPO, "config", "LNDP.yaml")
STAGES = ("fabricate", "untrained_24", "train_matcher", "train_neco",
          "trained_24", "trained_100", "trained_lo", "stage_timers", "c5",
          "ft_matcher_3dmb", "train_neco_3dmb", "eval_3dmatch", "bench",
          "untrained_100", "targets")
# the JAX package's trained, uncapped LNDP sweep of 4DMatch-F (100 pairs)
JAX_LEDGER = "snapshot/onchip_r5/lndp_full_rep/4DMatch-F.pairs.jsonl"


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", default="data/split",
                    help="where the splits are written (scripts/"
                         "make_suites.py's root: the ledgers' pair names "
                         "then match the JAX package's in snapshot/)")
    ap.add_argument("--ckpt", default=os.path.join(REPO, "build", "learning",
                                                   "ckpt"))
    ap.add_argument("--out", default=os.path.join(REPO, "build", "learning",
                                                  "out"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="a few pairs a split, one epoch a training")
    ap.add_argument("--stages", nargs="*", default=list(STAGES),
                    choices=STAGES)
    args = ap.parse_args(argv)

    import torch

    from bench_lndp_torch import card_line
    from deformationpyramid_tpu_torch.cli import (eval_3dmatch,
                                                  eval_supervised,
                                                  train_matcher, train_neco)

    q = args.quick
    n4d = 3 if q else 100
    n_first = 2 if q else 24
    epochs = dict(matcher=1 if q else 20, neco=1 if q else 8,
                  matcher_3dmb=1 if q else 16, neco_3dmb=1 if q else 8)
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(args.ckpt, exist_ok=True)
    data, ckpt, out, dev = args.data, args.ckpt, args.out, args.device
    matcher_best = os.path.join(ckpt, "matcher", "matcher_best_loss.npz")
    landmark = os.path.join(ckpt, "landmark_trained.npz")
    matcher_3dmb = os.path.join(ckpt, "matcher_3dmb", "matcher_best_loss.npz")
    landmark_3dmb = os.path.join(ckpt, "landmark_trained_3dmb.npz")
    summary: dict = {"card": card_line(torch.device(dev)), "quick": q,
                     "stages": {}}

    def lndp(tag, split, weights=None, limit=None, extra=()):
        argv = ["--config", CONFIG, "--data-root", data, "--splits", split,
                "--device", dev, "--log-dir", os.path.join(out, tag),
                *extra]
        if weights:
            argv += ["--weights", weights]
        if limit is not None:
            argv += ["--limit", str(limit)]
        rep = eval_supervised.main(argv)[split]
        return {"scores": rep["scores"], "pairs": rep["pairs"],
                "seconds": rep["seconds"],
                "iters_total": sum(sum(v) for v in rep["iters"].values())}

    def history(snap_dir, tag):
        src = os.path.join(snap_dir, "history.jsonl")
        shutil.copy(src, os.path.join(out, f"{tag}_history.jsonl"))
        return read_jsonl(src)

    def fabricate():
        from deformationpyramid_tpu_torch.data.synthetic import (
            write_3dmatch_suite, write_3dmatch_train_suite,
            write_4dmatch_suite)

        for split in ("train", "val", "4DMatch-F", "4DLoMatch-F",
                      "train-3dm-b", "val-3dm-b", "train-3dm-c", "3DMatch"):
            shutil.rmtree(os.path.join(data, split), ignore_errors=True)
        n = len(write_4dmatch_suite(data, "train", n_pairs=4 if q else 32,
                                    size_clusters=(6000,), seed=7))
        n += len(write_4dmatch_suite(data, "val", n_pairs=2 if q else 8,
                                     size_clusters=(6000,), seed=71))
        n += len(write_4dmatch_suite(data, "4DMatch-F", n_pairs=n4d))
        n += len(write_4dmatch_suite(data, "4DLoMatch-F", n_pairs=n4d,
                                     partial=0.40, seed=1))
        n += len(write_3dmatch_train_suite(data, "train-3dm-b",
                                           n_pairs=4 if q else 32, seed=24))
        n += len(write_3dmatch_train_suite(data, "val-3dm-b",
                                           n_pairs=2 if q else 8, seed=25))
        n += len(write_3dmatch_train_suite(data, "train-3dm-c",
                                           n_pairs=4 if q else 32, seed=26))
        write_3dmatch_suite(data, "3DMatch", n_pairs=2 if q else 20, seed=23)
        return {"pairs": n, "fragment_pairs": 2 if q else 20}

    def untrained_24():
        return lndp("lndp_random_24", "4DMatch-F", limit=n_first)

    def untrained_100():
        return lndp("lndp_random_100", "4DMatch-F")

    def run_train_matcher():
        snap = os.path.join(ckpt, "matcher")
        shutil.rmtree(snap, ignore_errors=True)
        train_matcher.main(["--config", CONFIG, "--data-root", data,
                            "--epochs", str(epochs["matcher"]), "--lr",
                            "1e-4", "--snapshot-dir", snap, "--device", dev])
        rows = history(snap, "matcher")
        return {"epochs": [{k: r[k] for k in ("epoch", "loss",
                                              "recall_coarse",
                                              "precision_coarse")}
                           for r in rows]}

    def run_train_neco():
        snap = os.path.join(ckpt, "neco")
        shutil.rmtree(snap, ignore_errors=True)
        train_neco.main(["--config", CONFIG, "--data-root", data,
                         "--epochs", str(epochs["neco"]), "--matcher-weights",
                         matcher_best, "--save-landmark", landmark,
                         "--snapshot-dir", snap, "--device", dev])
        return {"history": history(snap, "neco")}

    def trained_24():
        return lndp("lndp_trained_24", "4DMatch-F", landmark, limit=n_first)

    def trained_100():
        return lndp("lndp_trained_100", "4DMatch-F", landmark)

    def trained_lo():
        return lndp("lndp_trained_lo", "4DLoMatch-F", landmark)

    def stage_timers():
        tag = "lndp_trained_timers"
        res = lndp(tag, "4DMatch-F", landmark, limit=min(8, n4d),
                   extra=["--stage-timers"])
        rows = read_jsonl(os.path.join(out, tag, "4DMatch-F.pairs.jsonl"))
        stages = {k: [r["stages_ms"][k] for r in rows]
                  for k in ("matcher", "neco", "solve", "metrics")}
        solve_ms = sum(stages["solve"])
        res.update(stages_ms=stages,
                   landmarks=[r["n_landmarks"] for r in rows],
                   solve_ms_per_iter=solve_ms / max(res["iters_total"], 1))
        return res

    def c5():
        """C5 alone at the trained stack's landmark rows: each pair's rows
        are its coarse cap (2048 or 4096), its valid rows the landmarks."""
        import numpy as np

        import chip_smoke
        from deformationpyramid_tpu_torch.models.pyramid import NDPConfig

        rows = read_jsonl(os.path.join(out, "lndp_trained_100",
                                       "4DMatch-F.pairs.jsonl"))
        valid = int(round(float(np.mean([r["n_landmarks"] for r in rows]))))
        cfg = NDPConfig(**chip_smoke.LNDP_PYRAMID)
        res = {"mean_landmarks": valid}
        for n_rows in (2048, 4096):
            r = chip_smoke.ldmk_case(torch.device(dev), cfg, n_rows,
                                     min(valid, n_rows), seed=7, timed=True)
            res[f"rows_{n_rows}"] = {k: r[k] for k in (
                "valid", "ms", "plain_ms", "bound_ms", "bound_by", "err",
                "blocks", "tile")}
        return res

    def ft_matcher_3dmb():
        snap = os.path.join(ckpt, "matcher_3dmb")
        shutil.rmtree(snap, ignore_errors=True)
        train_matcher.main(["--config", CONFIG, "--data-root", data,
                            "--split", "train-3dm-b", "--epochs",
                            str(epochs["matcher_3dmb"]), "--lr", "3e-5",
                            "--resume-weights", matcher_best,
                            "--snapshot-dir", snap, "--device", dev])
        rows = history(snap, "matcher_3dmb")
        return {"epochs": [{k: r[k] for k in ("epoch", "loss",
                                              "recall_coarse",
                                              "precision_coarse")}
                           for r in rows]}

    def train_neco_3dmb():
        snap = os.path.join(ckpt, "neco_3dmb")
        shutil.rmtree(snap, ignore_errors=True)
        train_neco.main(["--config", CONFIG, "--data-root", data,
                         "--split", "train-3dm-c", "--no-augment",
                         "--epochs", str(epochs["neco_3dmb"]),
                         "--matcher-weights", matcher_3dmb,
                         "--save-landmark", landmark_3dmb,
                         "--snapshot-dir", snap, "--device", dev])
        return {"history": history(snap, "neco_3dmb")}

    def run_eval_3dmatch():
        res = {}
        for tag, extra in (("neco", []),
                           ("ransac_only", ["--no-reject-outliers"])):
            res[tag] = eval_3dmatch.main([
                "--config", CONFIG, "--weights", landmark_3dmb,
                "--info", os.path.join(data, "3DMatch", "test_info.npz"),
                "--base-dir", data, "--device", dev, "--log-dir",
                os.path.join(out, f"threedmatch_{tag}"), *extra])
        return res

    def bench():
        import bench_lndp_torch

        return bench_lndp_torch.main([
            "--limit", str(min(25, n4d)), "--reps", "1" if q else "3",
            "--weights", landmark, "--data-root", data, "--device", dev])

    def targets():
        """The JAX package's ledger of the trained, uncapped stack
        (JAX_LEDGER, a TPU run: its accuracy only) on the pair names of
        this run's 24- and 100-pair ledgers, beside this run's means."""
        import numpy as np

        with open(os.path.join(REPO, JAX_LEDGER)) as f:
            jax_rows = {os.path.normpath(r["name"]): r
                        for r in map(json.loads, f)}
        res = {}
        for tag in ("lndp_trained_24", "lndp_trained_100"):
            rows = read_jsonl(os.path.join(out, tag, "4DMatch-F.pairs.jsonl"))
            names = [os.path.normpath(r["name"]) for r in rows]
            if not all(n in jax_rows for n in names):
                res[tag] = "pair names not in the JAX ledger"
                continue
            res[tag] = {k: {"jax": float(np.mean([jax_rows[n][k]
                                                  for n in names])),
                            "port": float(np.mean([r[k] for r in rows]))}
                        for k in ("full-epe", "IR", "NRFMR", "n_landmarks")}
        return res

    fns = dict(fabricate=fabricate, untrained_24=untrained_24,
               train_matcher=run_train_matcher, train_neco=run_train_neco,
               trained_24=trained_24, trained_100=trained_100,
               trained_lo=trained_lo, stage_timers=stage_timers, c5=c5,
               ft_matcher_3dmb=ft_matcher_3dmb,
               train_neco_3dmb=train_neco_3dmb, eval_3dmatch=run_eval_3dmatch,
               bench=bench, untrained_100=untrained_100, targets=targets)
    t_all = time.perf_counter()
    try:
        for name in STAGES:
            if name not in args.stages:
                continue
            print(f"[learning] {name} start", flush=True)
            t0 = time.perf_counter()
            res = fns[name]()
            dt = time.perf_counter() - t0
            summary["stages"][name] = {"seconds": dt, "result": res}
            print(f"[learning] {name} {dt:.1f} s: {json.dumps(res)[:2000]}",
                  flush=True)
            with open(os.path.join(out, "summary.json"), "w") as f:
                json.dump(summary, f, indent=1)
    finally:
        summary["seconds"] = time.perf_counter() - t_all
        with open(os.path.join(out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(json.dumps({"learning": {k: v["seconds"] for k, v in
                                       summary["stages"].items()},
                          "seconds": summary["seconds"],
                          "card": summary["card"]}), flush=True)
    return summary


if __name__ == "__main__":
    main()
