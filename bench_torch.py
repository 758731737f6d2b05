"""Benchmark harness of the PyTorch port: registration throughput on one
CUDA GPU, the twin of ``bench.py``'s ``main``.

    python bench_torch.py [--total 32] [--reps 3] [--n 2000] [--device cuda]

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline",
"backend"}; ms per iteration, the iterations run, the per-repetition samples
and their spread on stderr.

Workload, as ``bench.py``: the full NDP configuration (config/NDP.yaml: m 9,
k0 -8, depth 3, width 128, 500 iterations a level, lr 0.01, early stop 15 @
0.001, 2000 samples, SE3 + axis_angle) on ``make_batch(1, n=2000,
seed=100 + c, deform=0.12)`` pairs, c = 0 .. total - 1, solved one after
another, after one warm-up pair; the median of ``--reps`` repetitions. The
routes come from the same environment variables as ``bench.py``'s:

  BENCH_FUSED_ITER  the fused iteration (default 1; C2, C1, C6, C3, C4)
  BENCH_FUSED_WARP  use_fused: the standalone level warp (C2, C3 + C13)
  BENCH_FUSED_CD    use_fused_chamfer: the one-call chamfer (C12)
  BENCH_TRANSPOSED  transposed: with BENCH_FUSED_WARP, the same kernels on
                    [3, N] points; alone, the plain warp

Baseline, as ``bench.py``: the reference's sequential loop at ~1.5 s a pair
on a desktop GPU, so vs_baseline is against 1 / 1.5 = 0.67 pairs/s.
``--device cpu`` with a small ``--n`` runs the kernels' plain versions: a
test of the harness, not a measurement.

    python bench_torch.py --streaming [--total 16] [--slots 4] [--n 2000]
                          [--k-inner 100] [--device cuda]

is ``bench.py``'s ``main_streaming``: continuous batching
(``solve/streaming.py register_stream``, every slot's 1-NN in one launch of
kernel C1) on ``make_batch(total + slots, n, seed=0, deform=0.12)``, a
warm-up on the first ``slots`` pairs (generator seed 0), then the other
``total`` timed (seed 1). One JSON line on stdout: {"metric", "value",
"unit", "card"} (no vs_baseline, as ``bench_lndp_torch.py``); the pairs'
EPE against their initial flow, the seconds and the iterations on stderr.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from bench_lndp_torch import card_line
from deformationpyramid_tpu_torch.data.synthetic import make_batch
from deformationpyramid_tpu_torch.models.pyramid import NDPConfig
from deformationpyramid_tpu_torch.solve.registration import (SolverConfig,
                                                             register_pair)

BASELINE_PAIRS_PER_SEC = 1.0 / 1.5  # reference sequential loop, single GPU


def _flag(env, name: str, default: str = "0") -> bool | None:
    return bool(int(env.get(name, default))) or None


def make_cfg(env=os.environ) -> SolverConfig:
    """``bench.py``'s ``CFG``, read from the same environment variables."""
    return SolverConfig(
        pyramid=NDPConfig(m=9, k0=-8, depth=3, width=128,
                          rotation_format="axis_angle", motion="SE3"),
        iters=500, lr=0.01, max_break_count=15, break_threshold_ratio=0.001,
        samples=2000,
        use_fused=_flag(env, "BENCH_FUSED_WARP"),
        use_fused_chamfer=_flag(env, "BENCH_FUSED_CD"),
        transposed=(bool(int(env["BENCH_TRANSPOSED"]))
                    if "BENCH_TRANSPOSED" in env else None),
        use_fused_iteration=_flag(env, "BENCH_FUSED_ITER", "1"),
    )


CFG = make_cfg()


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--total", type=int, default=None,
                    help="timed pairs (32; 16 with --streaming)")
    ap.add_argument("--reps", type=int, default=3, help="repetitions")
    ap.add_argument("--n", type=int, default=2000, help="points a cloud")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--streaming", action="store_true",
                    help="continuous batching (solve/streaming.py)")
    ap.add_argument("--slots", type=int, default=4,
                    help="--streaming: slots solved at once")
    ap.add_argument("--k-inner", type=int, default=100,
                    help="--streaming: iterations between two host polls")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if args.streaming:
        return main_streaming(args.total or 16, args.slots, args.n,
                              args.k_inner, dev)
    args.total = args.total or 32

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def batch(seed):
        src, tgt, _ = make_batch(1, n=args.n, seed=seed, deform=0.12)
        return torch.from_numpy(src[0]).to(dev), torch.from_numpy(tgt[0]).to(dev)

    # warm-up: builds and loads the kernels, fills the allocator
    warped, _ = register_pair(0, *batch(0), CFG)
    sync()
    # every timed pair staged on the device first: generation is excluded
    pairs = [batch(100 + c) for c in range(args.total)]
    samples, rep_iters = [], []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        outs = [register_pair(10 + c, s, t, CFG)
                for c, (s, t) in enumerate(pairs)]
        sync()
        dt = time.perf_counter() - t0
        samples.append(args.total / dt)
        rep_iters.append(sum(int(st["iters"].sum()) for _, st in outs))

    pairs_per_sec = float(statistics.median(samples))
    order = sorted(range(len(samples)), key=samples.__getitem__)
    total_iters = rep_iters[order[len(samples) // 2]]
    ms_per_iter = args.total / pairs_per_sec * 1e3 / max(total_iters, 1)
    routes = {k: getattr(CFG, k) for k in (
        "use_fused_iteration", "use_fused", "use_fused_chamfer",
        "transposed")}
    detail = {
        "ms_per_iteration": round(ms_per_iter, 4),
        "lockstep_iters": total_iters,
        "chunk": 1,
        "samples_pairs_per_sec": [round(s, 3) for s in samples],
        "spread": round(max(samples) - min(samples), 3),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "routes": routes,
    }
    print(json.dumps(detail), file=sys.stderr, flush=True)
    line = {
        "metric": "ndp_registration_throughput",
        "value": round(pairs_per_sec, 3),
        "unit": "pairs/s",
        "vs_baseline": round(pairs_per_sec / BASELINE_PAIRS_PER_SEC, 2),
        "backend": f"torch-{dev.type}",
    }
    print(json.dumps(line), flush=True)
    return dict(line, **detail)


def main_streaming(total: int, n_slots: int, n_points: int, k_inner: int,
                   dev: torch.device) -> dict:
    """``bench.py``'s ``main_streaming``: continuous batching, no lockstep
    tail. Returns the line with the detail."""
    from deformationpyramid_tpu_torch.solve.streaming import register_stream

    srcs, tgts, flows = make_batch(total + n_slots, n=n_points, seed=0,
                                   deform=0.12)
    pairs = [(torch.from_numpy(srcs[i]).to(dev),
              torch.from_numpy(tgts[i]).to(dev))
             for i in range(total + n_slots)]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # warm-up: builds and loads the kernels, fills the allocator
    register_stream(pairs[:n_slots], CFG, n_slots=n_slots, k_inner=k_inner,
                    gen=torch.Generator().manual_seed(0), device=dev)
    sync()
    t0 = time.perf_counter()
    warped = register_stream(pairs[n_slots:], CFG, n_slots=n_slots,
                             k_inner=k_inner,
                             gen=torch.Generator().manual_seed(1), device=dev)
    sync()
    dt = time.perf_counter() - t0
    epe, epe0 = [], []
    for i, w in enumerate(warped):
        src, flow = srcs[n_slots + i], flows[n_slots + i]
        w = w.cpu().numpy()
        epe.append(float(np.linalg.norm(w - src - flow, axis=1).mean()))
        epe0.append(float(np.linalg.norm(flow, axis=1).mean()))
    detail = {"mode": "streaming", "pairs": total, "slots": n_slots,
              "k_inner": k_inner, "seconds": dt, "epe": epe,
              "initial_epe": epe0,
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu")}
    print(json.dumps(detail), file=sys.stderr, flush=True)
    line = {"metric": "ndp_registration_throughput",
            "value": round(total / dt, 3),
            "unit": "pairs/s",
            "card": card_line(dev)}
    print(json.dumps(line), flush=True)
    return dict(line, **detail)


if __name__ == "__main__":
    main()
