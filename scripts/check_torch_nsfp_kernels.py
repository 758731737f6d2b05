#!/usr/bin/env python3
"""The kernels of the no-learned evaluation alone on one CUDA GPU: what
ptxas says of C10 / C11 (csrc/nsfp.cu) and of the level kernels' nine
(motion, format) instantiations (registers, shared memory, spills), then
``chip_smoke.py``'s own cases: C10, C11, C4 and C11 + C4 at the NSFP
shapes, C2 / C3 for sflow, quaternion and 6D, and C5 at SE3 + quaternion;
the sha256 of C2's, C3's and C5's outputs on fixed inputs
(``chip_smoke.c2_c5_digests``); and C11's tile: C11 alone and C11 + C4 at
2000 points with 16 and 32 points a block (125 and 63 partial rows), each
held to the float64 gradient and repeated bit for bit, timed in the order
16, 32, 32, 16.

    python3 scripts/check_torch_nsfp_kernels.py [OUT_DIR]

Run it in this tree and in the parent's through ``scripts/ab_kernels.sh``
to compare both in one call (a tree without ``nsfp_bwd_tile`` skips the
tile timing). Writes ``OUT_DIR/nsfp_ptxas.txt`` (default
``build/profile``) and prints one line per kernel. Exits non-zero if a
kernel does not build, launch or agree.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import deformationpyramid_tpu_torch as dp  # noqa: E402
from deformationpyramid_tpu_torch.models.baselines import NSFPConfig  # noqa: E402
from deformationpyramid_tpu_torch.ops import cuda_lib  # noqa: E402
from deformationpyramid_tpu_torch.ops import fused_iteration as fi  # noqa: E402


def tile_timings(flat, x, g) -> dict:
    """C11 and C11 + C4 at 16 and 32 points a block, 2000 points."""
    ncfg = NSFPConfig()
    shapes = fi.nsfp_shapes(ncfg)
    ref = fi.nsfp_bwd_plain(flat.double(), x.double(), g.double(),
                            ncfg)[0].float()
    zero = torch.zeros((), device=flat.device)
    pa, ma, va = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
    rule = fi.nsfp_bwd_tile
    out = {}
    try:
        for tile in (16, 32, 32, 16):
            fi.nsfp_bwd_tile = lambda n, cfg: tile
            part = fi.nsfp_bwd(flat, x, g, ncfg)
            torch.cuda.synchronize()
            worst = chip_smoke.rel_grad_err(part.sum(0), ref, shapes,
                                            f"C11 at tile {tile}")
            chip_smoke.check(torch.equal(part, fi.nsfp_bwd(flat, x, g, ncfg)),
                             f"C11 at tile {tile} does not repeat")
            r = out.setdefault(tile, dict(rows=part.shape[0], worst=worst,
                                          c11_ms=[], c4_ms=[], pair_ms=[]))
            r["c11_ms"].append(chip_smoke.cuda_ms(
                lambda: fi.nsfp_bwd(flat, x, g, ncfg)))
            r["c4_ms"].append(chip_smoke.cuda_ms(
                lambda: fi.adam_step(pa, ma, va, part, zero, zero, 0.01)))
            r["pair_ms"].append(chip_smoke.cuda_ms(
                lambda: fi.adam_step(pa, ma, va, fi.nsfp_bwd(flat, x, g, ncfg),
                                     zero, zero, 0.01)))
    finally:
        fi.nsfp_bwd_tile = rule
    for tile, r in out.items():
        print(f"C11 tile {tile}: {r['rows']} partial rows "
              f"({r['rows'] * 4 * flat.numel() / 1e6:.1f} MB), gradient worst "
              f"{r['worst']:.2e}; C11 {r['c11_ms']} ms, C4 {r['c4_ms']} ms, "
              f"C11 + C4 {r['pair_ms']} ms", flush=True)
    return out


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
    res = chip_smoke.nsfp_kernel_phase(dp, dev)
    print("digests " + json.dumps(chip_smoke.c2_c5_digests(dev)), flush=True)
    if hasattr(fi, "nsfp_bwd_tile"):
        tile_timings(*res["inputs"])
    else:
        print("no nsfp_bwd_tile in this tree: C11's tile is fixed", flush=True)
    chip_smoke.format_kernel_phase(dp, dev)
    chip_smoke.ldmk_kernel_phase(
        dp, dev, pyr=dict(chip_smoke.LNDP_PYRAMID,
                          rotation_format="quaternion"),
        timed=False)


if __name__ == "__main__":
    main()
