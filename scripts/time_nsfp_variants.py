#!/usr/bin/env python3
"""Times kernels C10 nsfp_fwd and C11 nsfp_bwd built from other copies of
their sources, on one CUDA GPU: for comparing variants of ``nsfp.cu`` and
``level_tile_tc.cuh`` (and the headers they include) in one call.

    python3 scripts/time_nsfp_variants.py DIR [DIR ...]

Each DIR holds those sources and ``adam.cu`` (a copy of
``deformationpyramid_tpu_torch/csrc`` with an edit, say; its other ``.cu``
files may be left out); all of them are built at once, each alone into
``DIR/build`` with the package's own nvcc flags, and bound through this
tree's wrappers, so the C entry points must keep their signatures. For each
DIR it prints, at ``chip_smoke.nsfp_kernel_phase``'s inputs (2000 points,
9 x 128), C10's and C11's device times (``chip_smoke.cuda_ms``), C11 + C4
back to back, C10's max abs error against its plain version and C11's
worst error against the float64 VJP (of a tensor's max |g|), and the
sha256 of C10's output and C11's rows; the DIRs are timed in the order
given and then in reverse.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
import deformationpyramid_tpu_torch as dp  # noqa: E402
from deformationpyramid_tpu_torch.models.baselines import NSFPConfig  # noqa: E402
from deformationpyramid_tpu_torch.ops import cuda_lib  # noqa: E402
from deformationpyramid_tpu_torch.ops import fused_iteration as fi  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dirs = [Path(d).resolve() for d in sys.argv[1:]]
    print(f"built {len(dirs)} variants in "
          f"{cuda_lib.build_variants(dirs):.1f} s", flush=True)
    dev = torch.device("cuda")
    flat, x, g = cs.nsfp_kernel_phase(dp, dev)["inputs"]
    ncfg = NSFPConfig()
    ref = fi.nsfp_fwd_plain(flat, x, ncfg)
    ref_g = fi.nsfp_bwd_plain(flat.double(), x.double(), g.double(),
                              ncfg)[0].float()
    zero = torch.zeros((), device=dev)
    pa, ma, va = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
    for d in dirs + dirs[::-1]:
        cuda_lib.use_variant(d)
        out = fi.nsfp_fwd(flat, x, ncfg)
        part = fi.nsfp_bwd(flat, x, g, ncfg)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        try:
            worst = cs.rel_grad_err(part.sum(0), ref_g, fi.nsfp_shapes(ncfg),
                                    d.name, tol=1.0)
        except AssertionError:
            worst = float("inf")
        fwd = cs.cuda_ms(lambda: fi.nsfp_fwd(flat, x, ncfg))
        bwd = cs.cuda_ms(lambda: fi.nsfp_bwd(flat, x, g, ncfg))
        pair = cs.cuda_ms(lambda: fi.adam_step(
            pa, ma, va, fi.nsfp_bwd(flat, x, g, ncfg), zero, zero, 0.01))
        print(f"{d.name:12s} C10 {fwd:.4f} ms (err {err:.1e}), C11 "
              f"{bwd:.4f} ms (worst {worst:.1e}), C11 + C4 {pair:.4f} ms; "
              f"sha256 C10 {cs.sha256_of(out)[:16]} C11 "
              f"{cs.sha256_of(part)[:16]}", flush=True)


if __name__ == "__main__":
    main()
