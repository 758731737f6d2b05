#!/usr/bin/env python3
"""Kernel C7 (csrc/flash_attention.cu) alone on one CUDA GPU: what ptxas
says of it (registers, shared memory, spills), then ``chip_smoke.py``'s
comparison with ``flash_attention_plain`` and its timings at more shapes
than the smoke run takes, with the rate each reaches.

    python3 scripts/check_flash_attention.py [OUT_DIR]

Writes ``OUT_DIR/flash_attention_ptxas.txt`` (default ``build/profile``)
and prints one line per shape. Exits non-zero if the kernel does not build,
launch or agree.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import flash_case  # noqa: E402
from deformationpyramid_tpu_torch.ops import cuda_lib  # noqa: E402

# L, S, src_len, heads, head width
SHAPES = ((2048, 2048, 1500, 4, 132), (2048, 2048, 2048, 4, 132),
          (1024, 1024, 900, 4, 132), (777, 1333, 1000, 4, 132),
          (777, 1333, 0, 4, 132), (130, 70, 70, 8, 18),
          (4096, 4096, 4096, 4, 132))


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else REPO / "build/profile"
    out.mkdir(parents=True, exist_ok=True)
    log = subprocess.run(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(cuda_lib.CSRC), "-c", str(cuda_lib.CSRC / "flash_attention.cu"),
         "-o", "/dev/null"], capture_output=True, text=True)
    (out / "flash_attention_ptxas.txt").write_text(log.stdout + log.stderr)
    print(log.stderr.strip()[-1500:], flush=True)
    if log.returncode != 0:
        raise RuntimeError("flash_attention.cu does not compile")
    _, secs = cuda_lib.build()
    print(f"build {secs:.1f} s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    for L, S, n, h, d in SHAPES:
        res = flash_case(dev, L, S, n, h, d, seed=0, timed=n > 0)
        if n:
            print(f"  {4.0 * L * n * h * d / res['ms'] / 1e9:.2f} TFLOP/s",
                  flush=True)


if __name__ == "__main__":
    main()
