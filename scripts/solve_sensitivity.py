#!/usr/bin/env python3
"""How far one NDP solve moves under float32 noise, and the fast path
against ``--no-fast`` beside it.

    python scripts/solve_sensitivity.py [--device cuda]
        [--iters 1 2 3 4 8 20 500] [--out build/solve_sensitivity]

Pair 1 of the fabricated 4DMatch-F (1392 / 1183 points, fewer than
``samples``: every path solves every point) goes through the fast path as
``cli/eval_nolearned.py`` runs it (``chip_smoke.pair1_flow``), with
``config/NDP.yaml`` at each count of ``--iters`` a level and the early
stop's plateau rule off, and at the yaml as it stands (the stop on). Then
again with (a) its valid sample rows in another order, (b) its sample
coordinates scaled by 1 + 1e-7, (c) ``--no-fast``. For each it prints the
largest gap of the flow from the first run's (cm), the gap of full-epe
(cm) and the largest relative gap of a level's final loss. (a) and (b) are
the same path on the same points; where they part as far as (c) does,
the gap between the paths is the solve's own sensitivity. The last line
is one JSON object with every number. Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from deformationpyramid_tpu_torch.cli import eval_nolearned as ev  # noqa: E402
from deformationpyramid_tpu_torch.data.synthetic import \
    write_4dmatch_suite  # noqa: E402

NS = 1392   # pair 1's source points


def permuted(st: np.ndarray) -> np.ndarray:
    out = st.copy()
    out[0, :NS] = st[0, np.random.default_rng(5).permutation(NS)]
    return out


def scaled(st: np.ndarray) -> np.ndarray:
    out = st.copy()
    out[0, :NS, :3] *= np.float32(1.0 + 1e-7)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, nargs="+",
                    default=[1, 2, 3, 4, 8, 20, 500])
    ap.add_argument("--out", default="build/solve_sensitivity")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(f"card: {smi}; torch {torch.__version__}")
    out = Path(args.out)
    write_4dmatch_suite(str(out / "split"), "4DMatch-F", n_pairs=2)
    yaml = (REPO / "config/NDP.yaml").read_text()
    runs = [(f"{k} a level, stop off", yaml.replace(
        "max_break_count: 15", f"max_break_count: {cs.NO_STOP}").replace(
        "iters: &iters 500", f"iters: &iters {k}")) for k in args.iters]
    runs.append(("500 a level, stop on", yaml))
    result = []
    for tag, text in runs:
        path = out / "NDP.yaml"
        path.write_text(text)
        flows, losses = [], []
        for kw in ({}, {"edit": permuted}, {"edit": scaled},
                   {"no_fast": True}):
            flow, gt, stats = cs.pair1_flow(ev, out / "split", str(path), dev,
                                            **kw)
            flows.append(flow)
            losses.append(stats["loss"])
        epe = [100.0 * float((f - gt).norm(dim=-1).mean()) for f in flows]
        row = {"run": tag, "full_epe_cm": epe[0]}
        line = f"{tag:22s} full-epe {epe[0]:.4f} cm"
        for name, f, ls, e in zip(("reordered", "scaled", "--no-fast"),
                                  flows[1:], losses[1:], epe[1:]):
            gap = dict(flow_cm=100.0 * float((f - flows[0]).abs().max()),
                       epe_cm=e - epe[0],
                       loss_rel=float(((ls - losses[0]).abs()
                                       / losses[0].abs()).max()))
            row[name] = gap
            line += (f" | {name}: flow {gap['flow_cm']:.2e} cm, epe "
                     f"{gap['epe_cm']:+.4f}, loss {gap['loss_rel']:.1e}")
        print(line, flush=True)
        result.append(row)
    print(json.dumps({"device": str(dev), "runs": result}))


if __name__ == "__main__":
    main()
