#!/usr/bin/env python3
"""The kernels of the solver's opt-in routes alone on one CUDA GPU: what
ptxas says of C12 (csrc/chamfer_fused.cu), C13 (csrc/adam.cu) and the level
kernels with the nonrigidity head (csrc/level_warp_nr.cu) beside the rigid
ones (registers, shared memory, spills), then ``chip_smoke.py``'s own
cases: C12 at 2000 x 2000 with masks and truncation, C13 on C3's partial
rows, and C2 / C3 with the nonrigidity head at levels 0 and 1.

    python3 scripts/check_torch_optin_kernels.py [OUT_DIR]

Writes ``OUT_DIR/optin_ptxas.txt`` (default ``build/profile``) and prints one
line per kernel. Exits non-zero if a kernel does not build, launch or agree.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import deformationpyramid_tpu_torch as dp  # noqa: E402
from deformationpyramid_tpu_torch.ops import cuda_lib  # noqa: E402

SOURCES = ("chamfer_fused.cu", "adam.cu", "level_warp.cu", "level_warp_nr.cu")


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else REPO / "build/profile"
    out.mkdir(parents=True, exist_ok=True)
    print(chip_smoke.machine_line(), flush=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(cuda_lib.CSRC), "-c", str(cuda_lib.CSRC / name), "-o",
         "/dev/null"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name in SOURCES]
    logs = []
    for name, proc in zip(SOURCES, procs):
        log = proc.communicate()[0]
        logs.append(f"== {name}\n{log}")
        print(f"{name}: nvcc rc {proc.returncode} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if proc.returncode != 0:
            print(log[-4000:], flush=True)
            raise RuntimeError(f"{name} does not compile")
    (out / "optin_ptxas.txt").write_text("\n".join(logs))
    for line in "\n".join(logs[:2]).splitlines():
        if "registers" in line or "spill" in line:
            print(line.strip(), flush=True)
    _, secs = cuda_lib.build()
    print(f"build {secs:.1f} s", flush=True)
    chip_smoke.optin_kernel_phase(dp, torch.device("cuda"))


if __name__ == "__main__":
    main()
