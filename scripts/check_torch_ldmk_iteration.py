#!/usr/bin/env python3
"""Kernel C5 ldmk_iteration alone on one CUDA GPU, with the bits of C2 and
C3, whose tile code C5 shares.

    python3 scripts/check_torch_ldmk_iteration.py [OUT_DIR]

At LNDP's pyramid (width 128, depth 3, SE3 + axis_angle, a mid level) it
checks C5 against its plain version at 2048 landmark rows with 2000 valid
and at the lndp path's 4096 rows with 30 valid (``chip_smoke.ldmk_case``:
the warped rows 1e-5, the loss 1e-6 relative, m / (1 - b1) and v / (1 - b2)
within 1e-4 / 2e-4 of each tensor's max, p 1e-6 where |m| > 1e-3 max|m|, a
held step exact, a second launch bit-equal) and prints its device time
(CUDA events, median of 30) beside the plain version's and the bound. It
prints the sha256 of C2's, C3's and C5's outputs on fixed inputs
(``chip_smoke.c2_c5_digests``) and, where the build reports them, ptxas's
registers and spill bytes of C5's nine instantiations. Run it in this tree
and in the parent's through ``scripts/ab_kernels.sh`` to compare both in
one call (with ``scripts/profile_torch_lndp.py`` for the landmark solve's
ms/iter). Writes ``OUT_DIR/check_torch_ldmk_iteration.json`` (default
``build/profile``); exits non-zero if a check failed.
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
from deformationpyramid_tpu_torch.models import pyramid  # noqa: E402
from deformationpyramid_tpu_torch.ops import cuda_lib  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else REPO / "build/profile"
    out.mkdir(parents=True, exist_ok=True)
    _, secs = cuda_lib.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"build {secs:.1f} s; {smi}", flush=True)
    dev = torch.device("cuda")
    report = dict(card=smi, failures=[], cases={})
    report["c5_ptxas"] = cs.c5_ptxas()
    print("C5 ptxas (registers / spill stores / spill loads): "
          + cs.ptxas_line(report["c5_ptxas"]), flush=True)
    report["digests"] = cs.c2_c5_digests(dev)
    print("digests " + json.dumps(report["digests"]), flush=True)
    cfg = pyramid.NDPConfig(**cs.LNDP_PYRAMID)
    for rows, valid, seed in ((cs.LDMK_ROWS, cs.N_LDMK, 5),
                              (cs.LNDP_ROWS, cs.LNDP_VALID, 6)):
        tag = f"{rows} rows, {valid} valid"
        try:
            report["cases"][tag] = cs.ldmk_case(dev, cfg, rows, valid, seed,
                                                timed=True)
        except AssertionError as exc:
            report["failures"].append(str(exc))
            print(f"FAILED: {exc}", flush=True)
    (out / "check_torch_ldmk_iteration.json").write_text(
        json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    if report["failures"]:
        raise SystemExit(f"{len(report['failures'])} check(s) failed")


if __name__ == "__main__":
    main()
