#!/usr/bin/env python3
"""Times kernel C3 level_warp_bwd built from other copies of its sources,
on one CUDA GPU: for comparing variants of ``level_warp.cu``,
``level_warp_nr.cu``, ``level_warp.cuh``, ``level_tile_tc.cuh`` (and the
headers they include) in one call.

    python3 scripts/time_level_warp_variants.py DIR [DIR ...]

Each DIR holds those sources (a copy of ``deformationpyramid_tpu_torch/
csrc`` with an edit, say; its other ``.cu`` files may be left out); all of
them are built at once, each alone into ``DIR/build`` with the package's
own nvcc flags, and bound through this tree's wrapper, so the C entry point
must keep its signature. For each DIR it prints C3's device time
(``chip_smoke.cuda_ms``) and its worst error against the plain version (of
a tensor's max |g|) at 2000 points (SE3 + axis_angle, tile 16, the bench's
inputs) and 6000 points (Sim3 + euler, tile 48). A DIR whose name holds
``phases`` is expected to write block 0's clock64() stamps, as cycles
since its first, into the first entries of its partial row: they are
printed for the 2000-point case.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from deformationpyramid_tpu_torch.models import pyramid  # noqa: E402
from deformationpyramid_tpu_torch.ops import cuda_lib  # noqa: E402
from deformationpyramid_tpu_torch.ops import fused_iteration as fi  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dirs = [Path(d).resolve() for d in sys.argv[1:]]
    print(f"built {len(dirs)} variants in "
          f"{cuda_lib.build_variants(dirs):.1f} s", flush=True)
    dev = torch.device("cuda")
    import scripts.check_torch_level_warp as chk  # noqa: E402
    cases = [c for c in chk.cases(dev)
             if c[0] in ("SE3+axis_angle, 2000", "Sim3+euler, 6000")]
    refs = [fi.level_warp_bwd_plain(f, x, g, lv, c, gn)[0]
            for _, c, f, x, g, gn, lv in cases]
    for d in dirs:
        cuda_lib.use_variant(d)
        line = f"{d.name:16s}"
        for (tag, c, f, x, g, gn, lv), ref in zip(cases, refs):
            try:
                part = fi.level_warp_bwd(f, x, g, lv, c, gn)
            except (RuntimeError, ValueError) as exc:
                line += f" | {tag}: not launched ({exc})"
                continue
            try:
                err = cs.rel_grad_err(part.sum(0), ref,
                                      pyramid.level_shapes(c), tag, tol=1.0)
            except AssertionError:
                err = float("inf")
            ms = cs.cuda_ms(lambda: fi.level_warp_bwd(f, x, g, lv, c, gn))
            line += f" | {tag}: {ms:.4f} ms, err {err:.1e}"
            if "phases" in d.name and x.shape[0] == 2000:
                line += f" | stamps {[int(v) for v in part[0, :16].tolist()]}"
        print(line, flush=True)


if __name__ == "__main__":
    main()
