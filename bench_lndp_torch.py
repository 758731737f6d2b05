#!/usr/bin/env python3
"""LNDP evaluation-path benchmark of the PyTorch port: suite throughput.

    python3 bench_lndp_torch.py [--split 4DMatch-F] [--limit 25] [--reps 3]
        [--weights snapshot/landmark_trained.npz] [--data-root data/split]

Counterpart of ``bench_lndp.py``: ``cli/eval_supervised.run_eval`` over the
first ``--limit`` pairs of a fabricated suite (``scripts/make_suites.py``'s
``write_4dmatch_suite`` arguments, or any 4DMatch-format split), ``--reps``
times, each into a fresh log directory. Prints ONE JSON line: the median
repetition's ``lndp_pairs_per_sec``, the best per-pair time of all
repetitions (``per_pair_best_s``), the weights used (``"random"``: the
landmark model of seed 0, which finds few landmarks, so a line is
comparable only at equal ``weights``) and the card's name and power limit.
config/LNDP.yaml's model and solver as ``eval_supervised`` builds them
(kernel C7 in the matcher, C5 in the solve on the card).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))


def card_line(device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the card in use."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(device.index or 0)], capture_output=True, text=True,
        timeout=60).stdout.strip()


def one_rep(cfg, lcfg, params, scfg, split: str, limit: int | None,
            device) -> dict:
    """One sweep into a fresh log directory -> its lndp_suite summary."""
    from deformationpyramid_tpu_torch.cli import eval_supervised

    with tempfile.TemporaryDirectory() as td:
        eval_supervised.run_eval(cfg, lcfg, params, scfg, [split],
                                 batch_limit=limit, log_dir=td,
                                 device=device)
        with open(os.path.join(td, f"{split}.log")) as f:
            log = f.read().splitlines()
    return next(json.loads(l) for l in log
                if l.startswith("{") and '"lndp_suite"' in l)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--split", default="4DMatch-F")
    ap.add_argument("--limit", type=int, default=25)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--weights", default="snapshot/landmark_trained.npz",
                    help="landmark-model npz; where the file is missing, "
                         "the model of seed 0")
    ap.add_argument("--data-root", default=None,
                    help="override the yaml's data_root")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import torch

    from deformationpyramid_tpu_torch.cli import eval_supervised as ev
    from deformationpyramid_tpu_torch.utils.checkpoint import load_pytree
    from deformationpyramid_tpu_torch.utils.config import load_config

    device = torch.device(args.device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    cfg = load_config(os.path.join(REPO, "config", "LNDP.yaml"))
    if args.data_root is not None:
        cfg["data_root"] = args.data_root
    lcfg = ev.landmark_config(cfg, max_matches=0)
    scfg = ev.solver_config(cfg, device)
    params = ev.init_landmark_model(torch.Generator().manual_seed(0), lcfg,
                                    device=device)
    have_weights = os.path.exists(args.weights)
    if have_weights:
        params = load_pytree(args.weights, params)

    reps = [one_rep(cfg, lcfg, params, scfg, args.split, args.limit, device)
            for _ in range(args.reps)]
    reps.sort(key=lambda s: s["pairs_per_sec"])
    med = reps[len(reps) // 2]
    best_per_pair = min((s["per_pair_s"]["best"] for s in reps
                         if s.get("per_pair_s")), default=None)
    line = {"metric": "lndp_pairs_per_sec",
            "value": med["pairs_per_sec"],
            "unit": "pairs/s",
            "per_pair_best_s": best_per_pair,
            "pairs": med["pairs"],
            "split": args.split,
            "weights": args.weights if have_weights else "random",
            "reps": args.reps,
            "card": card_line(device)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
