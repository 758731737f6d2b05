#!/usr/bin/env python3
"""The port's 100-pair suite sweeps against the JAX package's ledgers.

    python scripts/suite_parity_torch.py [--out build/suite_parity]
        [--modes fast nofast] [--profile-pairs 4]

Fabricates 4DMatch-F (100 pairs, the defaults) and 4DLoMatch-F (100 pairs,
``partial=0.40, seed=1``) under ``data/split/`` as ``scripts/make_suites.py``
does, with the port's bit-identical copy of ``write_4dmatch_suite``, and
checks that the first four 4DMatch-F pairs have 26968 / 1392 / 29750 / 3158
source points. Then it runs ``cli/eval_nolearned.py --config
config/NDP.yaml`` over both splits once per mode (``fast``: the fixed-shape
fast path; ``nofast``: ``--no-fast``), prints each sweep's pairs/s, and
compares each ledger with the JAX package's TPU ledger of the same split
in ``snapshot/onchip_r5/`` (``scripts/parity_torch_vs_ledger.py``). The
two modes are also compared with each other.
Last, ``--profile-pairs`` pairs of 4DMatch-F run again through the fast
path under ``torch.profiler``: the device-busy share of the window, the
launches an iteration and the top kernels.

Needs a CUDA device; imports no JAX. The ledgers and the profile go to
``--out``; the last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
SPLITS = {"4DMatch-F": {}, "4DLoMatch-F": {"partial": 0.40, "seed": 1}}
FIRST_SIZES = [26968, 1392, 29750, 3158]
JAX_LEDGERS = {
    ("fast", "4DMatch-F"): "snapshot/onchip_r5/ndp_suite_rep/4DMatch-F.pairs.jsonl",
    ("fast", "4DLoMatch-F"): "snapshot/onchip_r5/lo_suite_rep/4DLoMatch-F.pairs.jsonl",
}
JAX_LEDGERS[("nofast", "4DMatch-F")] = JAX_LEDGERS[("fast", "4DMatch-F")]
JAX_LEDGERS[("nofast", "4DLoMatch-F")] = JAX_LEDGERS[("fast", "4DLoMatch-F")]
MODE_ARGS = {"fast": [], "nofast": ["--no-fast"]}


def _ledger_tool():
    spec = importlib.util.spec_from_file_location(
        "parity_torch_vs_ledger", REPO / "scripts" / "parity_torch_vs_ledger.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fabricate(root: str) -> list[int]:
    from deformationpyramid_tpu_torch.data.fourdmatch import FourDMatchDataset
    from deformationpyramid_tpu_torch.data.synthetic import write_4dmatch_suite
    for split, kw in SPLITS.items():
        write_4dmatch_suite(root, split, **kw)
    ds = FourDMatchDataset(root, "4DMatch-F")
    return [len(ds[i].src) for i in range(4)]


def sweep(mode: str, out: Path) -> dict:
    """One CLI run over both splits in a process of its own."""
    extra = MODE_ARGS[mode]
    log_dir = out / mode
    cmd = [sys.executable, "-m", "deformationpyramid_tpu_torch.cli.eval_nolearned",
           "--config", "config/NDP.yaml", "--log-dir", str(log_dir), *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    (out / f"{mode}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{mode} sweep failed:\n{proc.stderr[-4000:]}")
    rates = [line for line in proc.stdout.splitlines() if "pairs/s" in line]
    print(f"[{mode}] {wall:.1f} s: " + " | ".join(rates), flush=True)
    return {"wall_s": wall, "rates": rates, "log_dir": str(log_dir)}


def profile(root: str, pairs: int, out: Path) -> dict:
    """The fast path over ``pairs`` pairs under torch.profiler."""
    from deformationpyramid_tpu_torch.cli import eval_nolearned
    argv = ["--config", "config/NDP.yaml", "--data-root", root,
            "--splits", "4DMatch-F", "--limit", str(pairs)]
    eval_nolearned.main(argv + ["--log-dir", str(out / "profile_warm")])
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rep = eval_nolearned.main(argv + ["--log-dir", str(out / "profile")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    iters = sum(sum(v) for v in rep["4DMatch-F"]["iters"].values())
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
    busy_us = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    res = {"pairs": pairs, "iterations": iters, "wall_s": wall,
           "device_busy_s": busy_us / 1e6,
           "device_busy_share": busy_us / 1e6 / wall,
           "launches": launches, "launches_per_iteration": launches / iters,
           "top": [{"name": n[:80], "ms": d / 1e3, "launches": c}
                   for d, c, n in rows[:12]]}
    print(f"[profile] {pairs} pairs, {iters} iterations, wall {wall:.3f} s, "
          f"device busy {busy_us / 1e6:.3f} s "
          f"({100 * res['device_busy_share']:.1f}%), "
          f"{res['launches_per_iteration']:.1f} launches/iteration", flush=True)
    for t in res["top"]:
        print(f"    {t['ms']:10.2f} ms {t['launches']:7d}  {t['name']}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/suite_parity")
    ap.add_argument("--modes", nargs="+", default=["fast", "nofast"],
                    choices=sorted(MODE_ARGS))
    ap.add_argument("--profile-pairs", type=int, default=4,
                    help="pairs in the profile window (0: no profile)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    os.chdir(REPO)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    root = "data/split"
    sizes = fabricate(root)
    print(f"first four 4DMatch-F source sizes: {sizes}")
    if sizes != FIRST_SIZES:
        print(f"expected {FIRST_SIZES}", file=sys.stderr)
        return 1
    tool = _ledger_tool()
    result = {"card": smi, "sizes": sizes, "sweeps": {}, "parity": []}
    for mode in args.modes:
        result["sweeps"][mode] = sweep(mode, out)

    def pair(label, a, b, pairs=100):
        rows_a, rows_b = tool.read_ledger(a), tool.read_ledger(b)
        if set(rows_a) != set(rows_b) or len(rows_a) != pairs:
            raise RuntimeError(f"{label}: the ledgers hold other names")
        res = tool.compare(rows_a, rows_b, ["full-epe", "vis-epe", "occ-epe"])
        for r in res:
            print(f"[{label}] {r['metric']}: {r['mean_a']:.4f} vs "
                  f"{r['mean_b']:.4f}, paired {r['diff']:+.4f} +- "
                  f"{r['half']:.4f} ({'includes' if r['includes_zero'] else 'EXCLUDES'} zero)")
        result["parity"].append({"label": label, "results": res})

    for mode in args.modes:
        for split in SPLITS:
            ref = JAX_LEDGERS.get((mode, split))
            if ref is None:
                continue
            mine = out / mode / f"{split}.pairs.jsonl"
            pair(f"{mode} {split} vs JAX", str(mine), ref)
    for i, m1 in enumerate(args.modes):
        for m2 in args.modes[i + 1:]:
            for split in SPLITS:
                pair(f"{m1} vs {m2} {split}",
                     str(out / m1 / f"{split}.pairs.jsonl"),
                     str(out / m2 / f"{split}.pairs.jsonl"))
    if args.profile_pairs:
        result["profile"] = profile(root, args.profile_pairs, out)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
