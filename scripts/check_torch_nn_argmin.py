#!/usr/bin/env python3
"""Kernel C14 ``nn_argmin`` (csrc/nn_argmin.cu) alone on one CUDA GPU: what
ptxas says of it and of C1 beside it (registers, spills), the sha256 of its
outputs on pinned inputs (``chip_smoke.c14_digests``, held against
``chip_smoke.C14_DIGESTS`` once pinned) and of C1's (``C1_DIGESTS``), its
edge cases bit-equal to the plain version and to C1's x -> y half
(``chip_smoke.c14_edge_check``), then ``chip_smoke.py``'s checks and times
at C1's shapes (2000 x 2000, 6000 x 6000) and at a fabricated 480 x 640
depth pair's clouds (the moved source against the source, ~40k x ~40k),
without and with a mask.

    python3 scripts/check_torch_nn_argmin.py [OUT_DIR]

Run it in this tree and in the parent's through ``scripts/ab_kernels.sh``
to compare both in one call. Writes ``OUT_DIR/check_torch_nn_argmin.json``
(default ``build/profile``) and prints one line per case. Exits non-zero if
the kernel does not build, launch or agree with its plain version, or its
bits differ from the pinned ones.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import chip_smoke as cs  # noqa: E402
from deformationpyramid_tpu_torch.data.synthetic import make_pair  # noqa: E402
from deformationpyramid_tpu_torch.ops import cuda_lib  # noqa: E402
from depth_pairs import make_depth_pair  # noqa: E402


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
    regs = [r for r in cs.nn_ptxas() if "nn_" in r["layout"]]
    print("ptxas (registers / spill stores / spill loads): "
          + cs.ptxas_line(regs), flush=True)
    dev = torch.device("cuda")
    report = dict(card=smi, ptxas=regs, failures=[])
    for name, got, pinned in (("C14", cs.c14_digests(dev), cs.C14_DIGESTS),
                              ("C1", cs.c1_digests(dev), cs.C1_DIGESTS)):
        report[f"{name}_digests"] = got
        print(f"{name} digests " + json.dumps(got), flush=True)
        if not pinned:
            print(f"{name}_DIGESTS not pinned yet", flush=True)
        elif got != pinned:
            report["failures"].append(f"{name} outputs differ from "
                                      f"{name}_DIGESTS")
    try:
        report["edge_cases"] = cs.c14_edge_check(dev)
        print(f"{report['edge_cases']} cases bit-equal to C1's x -> y half "
              "(the C1 edge cases also to the plain version)", flush=True)
    except AssertionError as exc:
        report["failures"].append(str(exc))
    cases = []
    for n in cs.C14_SHAPES:
        src, tgt, _ = make_pair(n=n, seed=0, deform=0.12)
        cases.append((f"{n} x {n}", torch.from_numpy(src).to(dev),
                      torch.from_numpy(tgt).to(dev), None))
    pair = make_depth_pair()
    x = torch.from_numpy(pair["tgt"]).to(dev)
    y = torch.from_numpy(pair["src"]).to(dev)
    yv = torch.from_numpy(
        np.random.default_rng(9).random(len(y)) > 0.3).to(dev)
    cases += [("depth pair", x, y, None), ("depth pair, masked", x, y, yv)]
    lib = None
    report["cases"] = {}
    for tag, x, y, yv in cases:
        try:
            r = cs.c14_case(dev, x, y, yv, tag,
                            library_ms=None if yv is None else lib)
        except AssertionError as exc:
            report["failures"].append(f"{tag}: {exc}")
            continue
        lib = r["library_ms"]
        report["cases"][tag] = r
        cs.print_kernel(f"nn_argmin [{tag}: {r['shape']}]", r)
    print(smi, flush=True)
    (out / "check_torch_nn_argmin.json").write_text(json.dumps(report,
                                                               indent=1))
    print(json.dumps(report), flush=True)
    if report["failures"]:
        raise SystemExit(f"{len(report['failures'])} check(s) failed: "
                         f"{report['failures']}")


if __name__ == "__main__":
    main()
