"""Run summaries for the suite sweeps: every sweep emits one JSON line of
the shape ``{best, median, spread, n}``, so a best-observed number always
travels with its median. Per-pair times are the intervals between
harvested pairs.

A copy of ``deformationpyramid_tpu/utils/reporting.py`` (the functions,
not the module docstring); a test holds ``split_summary`` equal to it.
"""
from __future__ import annotations

import json


def _bms(values: list[float]) -> dict:
    """{best, median, spread, n} over a value list (ms or s)."""
    vs = sorted(values)
    if not vs:
        return {}
    mid = len(vs) // 2
    median = vs[mid] if len(vs) % 2 else 0.5 * (vs[mid - 1] + vs[mid])
    return {"best": round(vs[0], 4), "median": round(median, 4),
            "spread": round(vs[-1] - vs[0], 4), "n": len(vs)}


def split_summary(metric: str, split: str, harvest_stamps: list[float],
                  n_done: int, total_s: float,
                  stages_ms: dict[str, list[float]] | None = None) -> str:
    """One JSON line summarizing a finished split sweep.

    ``harvest_stamps`` are perf_counter() values: the sweep start followed
    by one stamp per harvested pair. ``stages_ms`` (optional, from the
    ``--stage-timers`` instrumented mode) maps stage name -> per-pair ms
    list; each stage is summarized with the same {best, median, spread, n}
    shape (VERDICT r4 #2/#5: per-stage breakdown in the suite JSON).
    """
    diffs = sorted(b - a for a, b in zip(harvest_stamps, harvest_stamps[1:]))
    per_pair = {}
    if diffs:
        mid = len(diffs) // 2
        median = (diffs[mid] if len(diffs) % 2
                  else 0.5 * (diffs[mid - 1] + diffs[mid]))
        per_pair = {
            "best": round(diffs[0], 4),
            "median": round(median, 4),
            "spread": round(diffs[-1] - diffs[0], 4),
            "n": len(diffs),
        }
    out = {
        "metric": metric,
        "split": split,
        "pairs": n_done,
        "total_s": round(total_s, 2),
        "pairs_per_sec": round(n_done / total_s, 3) if total_s > 0 else None,
        "per_pair_s": per_pair,
    }
    if stages_ms:
        out["stages_ms"] = {k: _bms(v) for k, v in stages_ms.items() if v}
    return json.dumps(out)
