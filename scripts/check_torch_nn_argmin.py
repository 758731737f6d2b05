#!/usr/bin/env python3
"""Kernel C14 ``nn_argmin`` (csrc/nn_argmin.cu) alone on one CUDA GPU: what
ptxas says of it (registers, shared memory, spills), then ``chip_smoke.py``'s
checks and times at C1's shapes (2000 x 2000, 6000 x 6000) and at a
fabricated 480 x 640 depth pair's clouds (the moved source against the
source, ~40k x ~40k), without and with a mask.

    python3 scripts/check_torch_nn_argmin.py [OUT_DIR]

Writes ``OUT_DIR/nn_argmin_ptxas.txt`` (default ``build/profile``) and
prints one line per case. Exits non-zero if the kernel does not build,
launch or agree with its plain version.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import chip_smoke  # noqa: E402
from deformationpyramid_tpu_torch.data.synthetic import make_pair  # noqa: E402
from deformationpyramid_tpu_torch.ops import cuda_lib  # noqa: E402
from depth_pairs import make_depth_pair  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else REPO / "build/profile"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    log = subprocess.run(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(cuda_lib.CSRC), "-c", str(cuda_lib.CSRC / "nn_argmin.cu"), "-o",
         "/dev/null"], capture_output=True, text=True)
    (out / "nn_argmin_ptxas.txt").write_text(log.stdout + log.stderr)
    print(f"nn_argmin.cu: nvcc {time.perf_counter() - t0:.1f} s", flush=True)
    print(log.stderr.strip()[-2000:], flush=True)
    if log.returncode != 0:
        raise RuntimeError("nn_argmin.cu does not compile")
    _, secs = cuda_lib.build()
    print(f"build {secs:.1f} s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cases = []
    for n in chip_smoke.C14_SHAPES:
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
    for tag, x, y, yv in cases:
        r = chip_smoke.c14_case(dev, x, y, yv, tag,
                                library_ms=None if yv is None else lib)
        lib = r["library_ms"]
        chip_smoke.print_kernel(f"nn_argmin [{tag}: {r['shape']}]", r)


if __name__ == "__main__":
    main()
