#!/usr/bin/env python3
"""Kernel C12 ``chamfer_fused`` (csrc/chamfer_fused.cu) alone on one CUDA
GPU: what ptxas says of its two kernels and of C6 beside them (registers,
spills), the sha256 of its outputs on pinned inputs
(``chip_smoke.c12_digests``, held against ``chip_smoke.C12_DIGESTS`` once
pinned), its edge cases against the plain version on the CPU
(``chip_smoke.c12_edge_check``), then ``chip_smoke.c12_case``'s checks and
times: the opt-in route's case (the warped bench points, 2000 x 2000, ~5%
of each cloud masked out, the truncation at the median) beside the work it
replaces (C1 + glue + C6), 2000 x 2000 and 6000 x 6000 without masks
(truncation 1e9, and the median), and every column won by row 0 (the
bucket pass's serial chain of 2000 adds).

    python3 scripts/check_torch_chamfer_fused.py [OUT_DIR]

Run it in this tree and in the parent's through ``scripts/ab_kernels.sh``
to compare both in one call. Writes ``OUT_DIR/check_torch_chamfer_fused.json``
(default ``build/profile``) and prints one line per case. Exits non-zero if
a kernel does not build, launch or agree with its plain version, or its
bits differ from the pinned ones.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

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
    print(cs.machine_line(), flush=True)
    _, secs = cuda_lib.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"build {secs:.1f} s; {smi}", flush=True)
    regs = [r for r in cs.nn_ptxas() if "nn_" not in r["layout"]]
    print("ptxas (registers / spill stores / spill loads): "
          + cs.ptxas_line(regs), flush=True)
    dev = torch.device("cuda")
    report = dict(card=smi, ptxas=regs, failures=[])
    report["digests"] = cs.c12_digests(dev)
    print("C12 digests " + json.dumps(report["digests"]), flush=True)
    if not cs.C12_DIGESTS:
        print("C12_DIGESTS not pinned yet", flush=True)
    elif report["digests"] != cs.C12_DIGESTS:
        report["failures"].append("C12 outputs differ from C12_DIGESTS")
    try:
        report["edge_cases"] = cs.c12_edge_check(dev)
        print(f"{report['edge_cases']} edge cases bit-equal to the plain "
              "version on the CPU (sums 1e-5 relative)", flush=True)
    except AssertionError as exc:
        report["failures"].append(str(exc))
    _, warped, y, xv, yv, *_ = cs.c12_bench_inputs(dev)
    cases = [("opt-in route, masks, trunc median", (warped, y, xv, yv),
              dict(label=", masks"))]
    for n, seed in ((2000, 0), (6000, 3)):
        src, tgt, _ = make_pair(n=n, seed=seed, deform=0.12)
        x6 = torch.from_numpy(src - src.mean(0)).to(dev)
        y6 = torch.from_numpy(tgt - tgt.mean(0)).to(dev)
        cases += [(f"{n} x {n}, trunc 1e9", (x6, y6),
                   dict(trunc=1e9, replaced=n == 6000)),
                  (f"{n} x {n}, trunc median", (x6, y6),
                   dict(replaced=False))]
    cases.append(("one row 2000 x 2000",
                  cs.c12_edge_input(dev, "one row 2000 x 2000"),
                  dict(trunc=cs.C12_EDGE_TRUNC, replaced=False,
                       label=", every column on row 0")))
    report["cases"] = {}
    for tag, args, kw in cases:
        try:
            report["cases"][tag] = cs.c12_case(*args, **kw)
        except AssertionError as exc:
            report["failures"].append(f"{tag}: {exc}")
    print(smi, flush=True)
    (out / "check_torch_chamfer_fused.json").write_text(
        json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    if report["failures"]:
        raise SystemExit(f"{len(report['failures'])} check(s) failed: "
                         f"{report['failures']}")


if __name__ == "__main__":
    main()
