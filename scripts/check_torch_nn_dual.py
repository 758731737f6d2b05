#!/usr/bin/env python3
"""Kernel C1 ``nn_dual`` (csrc/nn_dual.cu) alone on one CUDA GPU: what
ptxas says of it (registers, shared memory, spills), the sha256 of its
outputs on pinned inputs (``chip_smoke.c1_digests``, held against
``chip_smoke.C1_DIGESTS``), its edge cases bit-equal to
the plain version (``chip_smoke.c1_edge_check``: exact ties across the
database's slices, slices without a valid row, +inf rows, sizes 1 to
2000), then ``chip_smoke.c1_case``'s checks and times at the solver's 2000
x 2000, the shape-transfer demo's 6000 x 6000 and 2000 x 2000 with ~30% of
each cloud masked out.

    python3 scripts/check_torch_nn_dual.py [OUT_DIR]

Run it in this tree and in the parent's through ``scripts/ab_kernels.sh``
to compare both in one call. Writes ``OUT_DIR/nn_dual_ptxas.txt`` and
``OUT_DIR/check_torch_nn_dual.json`` (default ``build/profile``) and prints
one line per case. Exits non-zero if the kernel does not build, launch or
agree with its plain version, or its bits differ from the pinned ones.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from deformationpyramid_tpu_torch.data.synthetic import make_pair  # noqa: E402
from deformationpyramid_tpu_torch.ops import cuda_lib  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else REPO / "build/profile"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    log = subprocess.run(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(cuda_lib.CSRC), "-c", str(cuda_lib.CSRC / "nn_dual.cu"), "-o",
         "/dev/null"], capture_output=True, text=True)
    (out / "nn_dual_ptxas.txt").write_text(log.stdout + log.stderr)
    print(f"nn_dual.cu: nvcc {time.perf_counter() - t0:.1f} s", flush=True)
    print(log.stderr.strip()[-2000:], flush=True)
    if log.returncode != 0:
        raise RuntimeError("nn_dual.cu does not compile")
    _, secs = cuda_lib.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"build {secs:.1f} s; {smi}", flush=True)
    dev = torch.device("cuda")
    report = dict(card=smi, failures=[])
    report["digests"] = cs.c1_digests(dev)
    print("digests " + json.dumps(report["digests"]), flush=True)
    if report["digests"] != cs.C1_DIGESTS:
        report["failures"].append("C1 outputs differ from C1_DIGESTS")
    try:
        report["edge_cases"] = cs.c1_edge_check(dev)
        print(f"{report['edge_cases']} edge cases bit-equal to the plain "
              "version", flush=True)
    except AssertionError as exc:
        report["failures"].append(str(exc))
    cases = []
    for n, seed in ((2000, 0), (6000, 3)):
        src, tgt, _ = make_pair(n=n, seed=seed, deform=0.12)
        cases.append((f"{n} x {n}", torch.from_numpy(src - src.mean(0)).to(dev),
                      torch.from_numpy(tgt - tgt.mean(0)).to(dev), None,
                      None))
    rng = np.random.default_rng(9)
    _, x, y, _, _ = cases[0]
    cases.append(("2000 x 2000, masked", x, y,
                  torch.from_numpy(rng.random(2000) > 0.3).to(dev),
                  torch.from_numpy(rng.random(2000) > 0.3).to(dev)))
    report["cases"] = {}
    for tag, x, y, xv, yv in cases:
        try:
            r = cs.c1_case(x, y, xv, yv)
        except AssertionError as exc:
            report["failures"].append(f"{tag}: {exc}")
            continue
        report["cases"][tag] = r
        cs.print_kernel(f"nn_dual [{tag}]", r)
    print(smi, flush=True)
    (out / "check_torch_nn_dual.json").write_text(json.dumps(report,
                                                             indent=1))
    print(json.dumps(report), flush=True)
    if report["failures"]:
        raise SystemExit(f"{len(report['failures'])} check(s) failed: "
                         f"{report['failures']}")


if __name__ == "__main__":
    main()
