"""Where the time of one step of the continuous-batching solver goes, on a
CUDA GPU.

    python scripts/profile_torch_streaming.py [--slots 4] [--steps 50]
                                              [--out DIR]

Builds the state of ``--slots`` bench pairs (``bench_torch.CFG``: width
128, depth 3, 2000 samples; ``make_batch(slots, n=2000, seed=0,
deform=0.12)``) and runs ``multi_step`` of ``solve/streaming.py`` for
``--steps`` iterations of every slot, once unprofiled (host clock around a
synchronise) and once under ``torch.profiler``. Prints the wall ms a step
(a step advances every slot by one iteration), the device time per kernel
name and the launches a step, the device-busy share of the window, and
writes the Chrome trace to ``--out``. Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--out", default="build/profile",
                    help="directory for the Chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    sys.path.insert(0, str(REPO))
    import bench_torch
    from deformationpyramid_tpu_torch.data.synthetic import make_batch
    from deformationpyramid_tpu_torch.solve import streaming

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    srcs, tgts, _ = make_batch(args.slots, n=2000, seed=0, deform=0.12)
    multi_step, _, _, init_one = streaming.make_stream_fns(bench_torch.CFG,
                                                           args.steps)
    gen = torch.Generator().manual_seed(0)
    state = streaming.stack_states([
        init_one(gen, torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev))
        for s, t in zip(srcs, tgts)])
    state = multi_step(state)          # warm-up: build, load, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = multi_step(state)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state = multi_step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = args.steps
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
    launches = sum(r[1] for r in rows)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "torch_streaming_trace.json"))
    print(f"{args.slots} slots x {steps} steps; unprofiled wall "
          f"{plain_wall * 1e3 / steps:.4f} ms/step; profiled wall "
          f"{wall * 1e3 / steps:.4f} ms/step, device busy "
          f"{busy / 1e3 / steps:.4f} ms/step "
          f"({100.0 * busy / 1e6 / wall:.1f}% of the window), "
          f"{launches / steps:.1f} launches/step")
    for dev_us, count, name in rows[:25]:
        print(f"{dev_us / steps:9.2f} us/step {count / steps:6.2f} "
              f"launches/step  {name[:90]}")
    print(json.dumps({"slots": args.slots, "steps": steps,
                      "unprofiled_wall_ms_per_step": plain_wall * 1e3 / steps,
                      "wall_ms_per_step": wall * 1e3 / steps,
                      "device_busy_ms_per_step": busy / 1e3 / steps,
                      "launches_per_step": launches / steps,
                      "kernels": [{"name": n, "us_per_step": d / steps,
                                   "launches_per_step": c / steps}
                                  for d, c, n in rows]}))


if __name__ == "__main__":
    main()
