#!/usr/bin/env python3
"""Times kernel C1 nn_dual built from other copies of its source, on one
CUDA GPU: for comparing variants of ``nn_dual.cu`` (its block shape, say)
in one call.

    python3 scripts/time_nn_dual_variants.py DIR [DIR ...]

Each DIR holds a copy of ``deformationpyramid_tpu_torch/csrc`` with an
edited ``nn_dual.cu`` (its other ``.cu`` files may be left out, the
headers it includes may not); all of them are built at once, each alone
into ``DIR/build`` with the package's own nvcc flags, and bound through
this tree's wrapper, so the C entry point must keep its signature. For each
DIR it prints whether its outputs on ``chip_smoke.c1_digest_inputs`` equal
those of this tree's C1 and C1's device time (``chip_smoke.cuda_ms``) at
2000 x 2000 and 6000 x 6000 (the inputs of ``chip_smoke.c1_case``).
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from deformationpyramid_tpu_torch.data.synthetic import make_pair  # noqa: E402
from deformationpyramid_tpu_torch.ops import cuda_lib, knn  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dirs = [Path(d).resolve() for d in sys.argv[1:]]
    print(f"built {len(dirs)} variants in "
          f"{cuda_lib.build_variants(dirs):.1f} s", flush=True)
    dev = torch.device("cuda")
    ref = cs.c1_digests(dev)
    shapes = []
    for n, seed in ((2000, 0), (6000, 3)):
        src, tgt, _ = make_pair(n=n, seed=seed, deform=0.12)
        shapes.append((n, torch.from_numpy(src - src.mean(0)).to(dev),
                       torch.from_numpy(tgt - tgt.mean(0)).to(dev)))
    for d in dirs:
        cuda_lib.use_variant(d)
        line = f"{d.name:16s} bits {'equal' if cs.c1_digests(dev) == ref else 'DIFFER'}"
        for n, x, y in shapes:
            ms = cs.cuda_ms(lambda: knn.nn_argmin_dual(x, y))
            line += f" | {n} x {n}: {ms:.4f} ms"
        print(line, flush=True)


if __name__ == "__main__":
    main()
