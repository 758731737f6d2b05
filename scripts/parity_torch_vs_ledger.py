#!/usr/bin/env python3
"""Paired per-pair comparison of two evaluation ledgers (``.pairs.jsonl``).

    python scripts/parity_torch_vs_ledger.py A.pairs.jsonl B.pairs.jsonl \\
        [--pairs 100] [--metrics full-epe vis-epe occ-epe]
        [--max-points 2000 [--gap 0.1]]

Each ledger has one JSON row a pair, with the pair's ``name`` and its
metrics, as ``cli/eval_nolearned.py`` of either package writes it. The two
files are joined on ``name``; both must hold the same ``--pairs`` names.
Printed: each file's mean of every metric, and for each the paired
difference d_p = A(p) - B(p) with its 95% t interval (df = n - 1; the
estimator of ``docs/PARITY.md``: single pairs are chaotic, the mean of
the paired differences over many pairs is not). The exit code is 1 when
the interval of the first metric (``full-epe``) excludes zero, 2 when the
names do not match, 0 otherwise. With ``--max-points`` it also prints
each pair's |A - B| of the first metric on the pairs whose source and
target both have at most that many points (read from the pair's npz at
its ledger name, from the working directory): the pairs that the fast
path and ``--no-fast`` solve on the same points, in another order, rather
than on two different subsamples; then how many differ by more than
``--gap``, the median and the largest.

Imports neither package: it compares the port's ledger with the JAX
package's ledgers kept in ``snapshot/`` on any machine.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
from scipy import stats


def paired_ci(diffs: np.ndarray) -> tuple[float, float]:
    """Mean of the paired differences and the half-width of its 95% t
    interval (df = n - 1)."""
    n = len(diffs)
    if n < 2:
        return float(diffs.mean()), float("nan")
    half = stats.t.ppf(0.975, n - 1) * diffs.std(ddof=1) / np.sqrt(n)
    return float(diffs.mean()), float(half)


def read_ledger(path: str) -> dict[str, dict]:
    """name -> row; a pair recorded twice (a resumed sweep) keeps its first
    row, as the CLI's resume does. Names are compared as normalised paths."""
    rows: dict[str, dict] = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                row = json.loads(line)
                rows.setdefault(os.path.normpath(row.pop("name")), row)
    return rows


def compare(a: dict[str, dict], b: dict[str, dict], metrics: list[str]
            ) -> list[dict]:
    """One result a metric: both means, the paired mean difference, the
    half-width of its interval, and whether the interval holds zero."""
    names = sorted(a)
    out = []
    for key in metrics:
        va = np.array([a[n][key] for n in names], np.float64)
        vb = np.array([b[n][key] for n in names], np.float64)
        mean, half = paired_ci(va - vb)
        out.append({"metric": key, "mean_a": float(va.mean()),
                    "mean_b": float(vb.mean()), "diff": mean, "half": half,
                    "includes_zero": bool(abs(mean) <= half)})
    return out


def same_point_gaps(a: dict[str, dict], b: dict[str, dict], metric: str,
                    max_points: int) -> dict[str, float]:
    """|A - B| of ``metric`` on each pair whose npz (at its name) has at
    most ``max_points`` source and target points."""
    gaps = {}
    for name in sorted(a):
        with np.load(name) as z:
            if max(len(z["s_pc"]), len(z["t_pc"])) <= max_points:
                gaps[name] = abs(a[name][metric] - b[name][metric])
    return gaps


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a", help="ledger A (.pairs.jsonl)")
    ap.add_argument("b", help="ledger B (.pairs.jsonl)")
    ap.add_argument("--pairs", type=int, default=100,
                    help="pairs both ledgers must hold (default 100)")
    ap.add_argument("--metrics", nargs="+",
                    default=["full-epe", "vis-epe", "occ-epe"],
                    help="metrics to compare; the exit code reads the first")
    ap.add_argument("--max-points", type=int, default=None,
                    help="also the per-pair gaps on pairs of at most this "
                         "many source and target points")
    ap.add_argument("--gap", type=float, default=0.1,
                    help="the gap that --max-points counts pairs beyond")
    args = ap.parse_args(argv)
    a, b = read_ledger(args.a), read_ledger(args.b)
    if set(a) != set(b) or len(a) != args.pairs:
        print(f"names differ: A has {len(a)}, B {len(b)}, "
              f"{len(set(a) & set(b))} shared; expected {args.pairs} in both")
        return 2
    results = compare(a, b, args.metrics)
    print(f"{len(a)} pairs: A = {args.a}, B = {args.b}")
    for r in results:
        print(f"{r['metric']:>10}: mean A {r['mean_a']:.4f}, mean B "
              f"{r['mean_b']:.4f}, paired A - B {r['diff']:+.4f} +- "
              f"{r['half']:.4f} (95% t, df {len(a) - 1}); interval "
              f"{'includes' if r['includes_zero'] else 'excludes'} zero")
    out = {"pairs": len(a), "a": args.a, "b": args.b, "results": results}
    if args.max_points is not None:
        gaps = same_point_gaps(a, b, args.metrics[0], args.max_points)
        for name, g in gaps.items():
            print(f"{name}: |A - B| {g:.4f}")
        vals = np.array(list(gaps.values()))
        out["same_points"] = {
            "pairs": len(vals), "over_gap": int((vals > args.gap).sum()),
            "median": float(np.median(vals)), "max": float(vals.max())}
        print(f"{args.metrics[0]} on the {len(vals)} pairs of <= "
              f"{args.max_points} points: {out['same_points']['over_gap']} "
              f"differ by more than {args.gap} (median "
              f"{out['same_points']['median']:.4f}, max "
              f"{out['same_points']['max']:.4f})")
    print(json.dumps(out))
    return 0 if results[0]["includes_zero"] else 1


if __name__ == "__main__":
    sys.exit(main())
