#!/usr/bin/env python3
"""Times the kernels on the split-database sweep (nn_sweep.cuh) built from
other copies of their sources, on one CUDA GPU: for comparing variants of
C1 nn_dual, C14 nn_argmin and C12 chamfer_fused (their block shapes, say)
in one call.

    python3 scripts/time_nn_dual_variants.py DIR [DIR ...]

Each DIR holds a copy of ``deformationpyramid_tpu_torch/csrc`` with edited
sources (C14's ``NNA_WARPS`` / ``NNA_QPL`` defines, say); it needs
``nn_dual.cu``, ``nn_argmin.cu``, ``chamfer_fused.cu`` and
``scatter_rows.cu`` and the headers they include, and its other ``.cu``
files may be left out. All of them are built at once, each alone into
``DIR/build`` with the package's own nvcc flags, and bound through this
tree's wrappers, so the C entry points must keep their signatures. For each
DIR it prints whether its outputs equal those of this tree's kernels
(``chip_smoke.c1_digests``, ``c14_digests``, ``c12_digests``) and the
device times (``chip_smoke.cuda_ms``) of C1 at 2000 x 2000 and 6000 x 6000
(the inputs of ``chip_smoke.c1_case``), of C14 at the same shapes and at a
fabricated depth pair's ~40k x ~37k clouds, of C12 on the opt-in
route's case (``chip_smoke.c12_bench_inputs``, the truncation at the
median), and of C6, which shares C12's bucket pass (bucket_rows.cuh), at
the cases of ``chip_smoke.scatter_case`` (2000 x 2000 on the sweep's
indices, 6000 x 6000, 2000 sources on one row).
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import chip_smoke as cs  # noqa: E402
from deformationpyramid_tpu_torch.data.synthetic import make_pair  # noqa: E402
from deformationpyramid_tpu_torch.ops import chamfer_fused as cf  # noqa: E402
from deformationpyramid_tpu_torch.ops import cuda_lib, knn  # noqa: E402
from deformationpyramid_tpu_torch.ops import fused_iteration as fi  # noqa: E402
from depth_pairs import make_depth_pair  # noqa: E402


def digests(dev) -> dict:
    return {**cs.c1_digests(dev), **cs.c14_digests(dev),
            **cs.c12_digests(dev)}


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dirs = [Path(d).resolve() for d in sys.argv[1:]]
    print(f"built {len(dirs)} variants in "
          f"{cuda_lib.build_variants(dirs):.1f} s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    ref = digests(dev)
    shapes = []
    for n, seed in ((2000, 0), (6000, 3)):
        src, tgt, _ = make_pair(n=n, seed=seed, deform=0.12)
        shapes.append((f"{n} x {n}",
                       torch.from_numpy(src - src.mean(0)).to(dev),
                       torch.from_numpy(tgt - tgt.mean(0)).to(dev)))
    pair = make_depth_pair()
    depth = (torch.from_numpy(pair["tgt"]).to(dev),
             torch.from_numpy(pair["src"]).to(dev))
    _, warped, y, xv, yv, *_ = cs.c12_bench_inputs(dev)
    rmin = cf.chamfer_fused_plain(warped, y, xv, yv, 1e9)[2]
    trunc = float(rmin[xv].median())
    c6 = []
    for tag, n, seed in (("2000", 2000, 0), ("6000", 6000, 1)):
        src, tgt, _ = make_pair(n=n, seed=seed, deform=0.12)
        a = torch.from_numpy(src - (src.mean(0) if n == 2000 else 0)).to(dev)
        b = torch.from_numpy(tgt - (tgt.mean(0) if n == 2000 else 0)).to(dev)
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        idx = knn.nn_argmin_dual(a, b, ones, ones)[3]
        c6.append((tag, (a - b) * 1e-3, idx, (b - a[idx]) * 1e-3))
    gen = torch.Generator().manual_seed(66)
    c6.append(("one row", (torch.randn(2000, 3, generator=gen) * 1e-3).to(dev),
               torch.full((2000,), 1234, dtype=torch.int64, device=dev),
               (torch.randn(2000, 3, generator=gen) * 1e-3).to(dev)))
    for d in dirs:
        cuda_lib.use_variant(d)
        got = digests(dev)
        differ = sorted(k for k in ref if got[k] != ref[k])
        line = f"{d.name:16s} bits {'DIFFER ' + str(differ) if differ else 'equal'}"
        for tag, a, b in shapes:
            line += (f" | C1 {tag}: "
                     f"{cs.cuda_ms(lambda: knn.nn_argmin_dual(a, b)):.4f}")
        for tag, a, b in (*shapes, (f"{len(depth[0])} x {len(depth[1])}",
                                    *depth)):
            line += (f" | C14 {tag}: "
                     f"{cs.cuda_ms(lambda: knn.nn_argmin(a, b)):.4f}")
        ms = cs.cuda_ms(lambda: cf.chamfer_fused(warped, y, xv, yv, trunc))
        line += f" | C12 2000 x 2000 masked: {ms:.4f}"
        for tag, dst, idx, src in c6:
            buf = dst.clone()
            line += (f" | C6 {tag}: "
                     f"{cs.cuda_ms(lambda: fi.scatter_add_rows(buf, idx, src)):.4f}")
        line += " (ms)"
        print(line, flush=True)


if __name__ == "__main__":
    main()
