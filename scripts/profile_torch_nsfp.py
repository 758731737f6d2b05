#!/usr/bin/env python3
"""The fused NSFP evaluation through the CLI on one CUDA GPU: ms/iter of
``eval_nolearned`` with ``config/baselines/NSFP.yaml`` and
``use_fused_iteration: true`` (C10, C1, the glue with C6, C11, C4 an
iteration), on the first 2 pairs of a fabricated 4DMatch-F split
(``write_4dmatch_suite``, as ``chip_smoke.py``'s nolearned phase makes it).

    python3 scripts/profile_torch_nsfp.py [OUT_DIR]

Two runs after a one-pair warm-up: the yaml as it stands (early stop on,
the 5000-iteration cap) and the same with the early stop off at 1000
iterations a pair, so that two trees do the same work. Each prints its
pairs, iterations, wall seconds and ms/iter (host clock around the CLI,
after a synchronise), the full-cloud EPE and the launches of C10 / C11;
then C10, C11 and C4 alone at 2000 points (``chip_smoke.cuda_ms``), whose
sum is the iteration's device time in those three. Run it in this tree and
in the parent's through ``scripts/ab_kernels.sh`` to compare both in one
call. Writes ``OUT_DIR/profile_torch_nsfp.json`` (default
``build/profile``).
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
import deformationpyramid_tpu_torch as dp  # noqa: E402
from deformationpyramid_tpu_torch.cli import eval_nolearned as ev  # noqa: E402
from deformationpyramid_tpu_torch.data.synthetic import \
    write_4dmatch_suite  # noqa: E402
from deformationpyramid_tpu_torch.ops import fused_iteration as fi  # noqa: E402

FIXED_ITERS = 1000


def run(cfg: Path, root: Path, log: Path, limit: int) -> dict:
    torch.cuda.synchronize()
    for k in (fi.NSFP_FWD, fi.NSFP_BWD):
        k.launches = 0
    t0 = time.perf_counter()
    report = ev.main(["--config", str(cfg), "--data-root", str(root),
                      "--device", "cuda", "--splits", "4DMatch-F",
                      "--log-dir", str(log), "--limit", str(limit)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r = report["4DMatch-F"]
    iters = sum(sum(v) for v in r["iters"].values())
    return dict(pairs=r["pairs"], iters=iters, seconds=dt,
                ms_per_iter=dt * 1e3 / iters, full_epe=r["scores"]["full-epe"],
                launches={k.name: k.launches
                          for k in (fi.NSFP_FWD, fi.NSFP_BWD)})


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else REPO / "build/profile"
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    work = REPO / "build" / "profile_nsfp"
    shutil.rmtree(work, ignore_errors=True)
    root = work / "split"
    write_4dmatch_suite(str(root), "4DMatch-F", n_pairs=2)
    text = (REPO / "config/baselines/NSFP.yaml").read_text()
    fused = work / "NSFP_fused.yaml"
    fused.write_text(text + "use_fused_iteration: true\n")
    fixed = work / "NSFP_fixed.yaml"
    for old in ("iters: 5000", "max_break_count: 70"):
        cs.check(old in text, f"NSFP.yaml has no {old!r}")
    fixed.write_text(text.replace("iters: 5000", f"iters: {FIXED_ITERS}")
                     .replace("max_break_count: 70",
                              f"max_break_count: {cs.NO_STOP}")
                     + "use_fused_iteration: true\n")
    run(fused, root, work / "warmup", limit=1)
    report = dict(card=smi)
    for tag, cfg in (("early stop on", fused),
                     (f"early stop off, {FIXED_ITERS} a pair", fixed)):
        r = report[tag] = run(cfg, root, work / tag.replace(" ", "_"), 2)
        print(f"NSFP fused, {tag}: {r['pairs']} pairs, {r['iters']} "
              f"iterations in {r['seconds']:.3f} s = {r['ms_per_iter']:.4f} "
              f"ms/iter; full-epe {r['full_epe']:.4f} cm; launches "
              f"{r['launches']}", flush=True)
    k = cs.nsfp_kernel_phase(dp, torch.device("cuda"))
    report["kernels_ms"] = {name: k[name]["ms"]
                            for name in ("nsfp_fwd", "nsfp_bwd")}
    report["kernels_ms"]["adam_step"] = k["adam_step_at_nsfp"]["ms"]
    print(f"C10 + C11 + C4 at 2000 points: "
          f"{sum(report['kernels_ms'].values()):.4f} ms "
          f"{report['kernels_ms']}", flush=True)
    (out / "profile_torch_nsfp.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
