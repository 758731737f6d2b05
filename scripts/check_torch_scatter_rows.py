#!/usr/bin/env python3
"""Kernel C6 ``scatter_rows`` (csrc/scatter_rows.cu) alone on one CUDA GPU:
what ptxas says of it (registers, shared memory, spills), then
``chip_smoke.py``'s checks and times (bit-equal to ``index_add_`` on the CPU
and on a repeat, one launch a call; beside it ``index_add_`` on the card)
at 2000 x 2000 on the solver's sweep indices (the y->x 1-NN of a bench
pair), at the shape-transfer demo's 6000 x 6000, and with all 2000 sources
on one row.

    python3 scripts/check_torch_scatter_rows.py [OUT_DIR]

Writes ``OUT_DIR/scatter_rows_ptxas.txt`` (default ``build/profile``) and
prints one line per case. Exits non-zero if the kernel does not build,
launch or agree with its plain version.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from deformationpyramid_tpu_torch.data.synthetic import make_pair  # noqa: E402
from deformationpyramid_tpu_torch.ops import cuda_lib, knn  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else REPO / "build/profile"
    out.mkdir(parents=True, exist_ok=True)
    log = subprocess.run(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(cuda_lib.CSRC), "-c", str(cuda_lib.CSRC / "scatter_rows.cu"),
         "-o", "/dev/null"], capture_output=True, text=True)
    (out / "scatter_rows_ptxas.txt").write_text(log.stdout + log.stderr)
    print(log.stderr.strip()[-1500:], flush=True)
    if log.returncode != 0:
        raise RuntimeError("scatter_rows.cu does not compile")
    _, secs = cuda_lib.build()
    print(f"build {secs:.1f} s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    src, tgt, _ = make_pair(n=2000, seed=0, deform=0.12)
    x = torch.from_numpy(src - src.mean(0)).to(dev)
    y = torch.from_numpy(tgt - tgt.mean(0)).to(dev)
    ones = torch.ones(2000, dtype=torch.bool, device=dev)
    rarg = knn.nn_argmin_dual(x, y, ones, ones)[3]
    chip_smoke.scatter_case(dev, (x - y) * 1e-3, rarg, (y - x[rarg]) * 1e-3,
                            "2000 x 2000, the sweep's indices")
    chip_smoke.scatter_extra_cases(dev)


if __name__ == "__main__":
    main()
