"""Where the time of one fused solver iteration goes, on a CUDA GPU.

    python scripts/profile_torch_iteration.py [--out DIR]

Runs one pyramid level of the bench configuration (width 128, depth 3,
2000 samples of a synthetic pair, level 4) through
``run_fused_level`` with the early stop disabled, so that exactly 200
iterations run, under ``torch.profiler``. Prints the device
time per kernel name (summed and per iteration), the device-busy share of
the window and the wall time per iteration, and writes the Chrome trace
to ``--out``. Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
ITERS = 200
LEVEL = 4


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile",
                    help="directory for the Chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    sys.path.insert(0, str(REPO))
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.models import pyramid
    from deformationpyramid_tpu_torch.ops.fused_iteration import \
        run_fused_level
    from deformationpyramid_tpu_torch.solve.loop import LoopConfig

    dev = torch.device("cuda", 0)
    cfg = pyramid.NDPConfig(m=9, k0=-8, depth=3, width=128)
    src, tgt, _ = make_pair(n=2000, seed=100, deform=0.12)
    x = torch.from_numpy(src - src.mean(0)).to(dev)
    y = torch.from_numpy(tgt - tgt.mean(0)).to(dev)
    ones = torch.ones(2000, dtype=torch.bool, device=dev)
    params = pyramid.level_params(pyramid.init_pyramid_params(
        torch.Generator().manual_seed(0), cfg, device=dev), LEVEL)
    lcfg = LoopConfig(iters=ITERS, loss_eps=0.0,
                      max_break_count=ITERS + 1)

    def run():
        out = run_fused_level(params, x, ones, y, ones, LEVEL, cfg, lcfg)
        torch.cuda.synchronize()
        return out

    run()  # warm-up: build, load, allocator
    t0 = time.perf_counter()
    run()
    plain_wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, _, stats = run()
        wall = time.perf_counter() - t0
    iters = int(stats["iters"])
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "torch_iteration_trace.json"))
    print(f"{iters} iterations; unprofiled wall "
          f"{plain_wall * 1e3 / iters:.4f} ms/iter; profiled wall "
          f"{wall * 1e3 / iters:.4f} ms/iter, "
          f"device busy {busy / 1e3 / iters:.4f} ms/iter "
          f"({100.0 * busy / 1e6 / wall:.1f}% of the window)")
    for dev_us, count, name in rows[:25]:
        print(f"{dev_us / iters:9.2f} us/iter {count / iters:6.2f} "
              f"launches/iter  {name[:90]}")
    print(json.dumps({"iters": iters,
                      "unprofiled_wall_ms_per_iter": plain_wall * 1e3 / iters,
                      "wall_ms_per_iter": wall * 1e3 / iters,
                      "device_busy_ms_per_iter": busy / 1e3 / iters,
                      "kernels": [{"name": n, "us_per_iter": d / iters,
                                   "launches_per_iter": c / iters}
                                  for d, c, n in rows]}))


if __name__ == "__main__":
    main()
