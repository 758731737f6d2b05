#!/usr/bin/env python3
"""The kernels of the no-learned evaluation alone on one CUDA GPU: what
ptxas says of C10 / C11 (csrc/nsfp.cu) and of the level kernels' nine
(motion, format) instantiations (registers, shared memory, spills), then
``chip_smoke.py``'s own cases: C10, C11 and C4 at the NSFP shapes, C2 / C3
for sflow, quaternion and 6D, and C5 at SE3 + quaternion.

    python3 scripts/check_torch_nsfp_kernels.py [OUT_DIR]

Writes ``OUT_DIR/nsfp_ptxas.txt`` (default ``build/profile``) and prints one
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


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else REPO / "build/profile"
    out.mkdir(parents=True, exist_ok=True)
    logs = []
    for name in ("nsfp.cu", "level_warp.cu", "ldmk_iteration.cu"):
        t0 = time.perf_counter()
        log = subprocess.run(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(cuda_lib.CSRC), "-c", str(cuda_lib.CSRC / name), "-o",
             "/dev/null"], capture_output=True, text=True)
        logs.append(log.stdout + log.stderr)
        print(f"{name}: nvcc {time.perf_counter() - t0:.1f} s", flush=True)
        if log.returncode != 0 or name == "nsfp.cu":
            print(log.stderr.strip()[-3000:], flush=True)
        if log.returncode != 0:
            raise RuntimeError(f"{name} does not compile")
    (out / "nsfp_ptxas.txt").write_text("\n".join(logs))
    _, secs = cuda_lib.build()
    print(f"build {secs:.1f} s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    chip_smoke.nsfp_kernel_phase(dp, dev)
    chip_smoke.format_kernel_phase(dp, dev)
    chip_smoke.ldmk_kernel_phase(
        dp, dev, pyr=dict(chip_smoke.LNDP_PYRAMID,
                          rotation_format="quaternion"),
        label="SE3+quaternion", timed=False)


if __name__ == "__main__":
    main()
