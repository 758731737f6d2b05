#!/usr/bin/env python3
"""Times kernel C5 ldmk_iteration built from other copies of its sources,
on one CUDA GPU: for comparing variants of ``ldmk_iteration.cu`` and
``level_tile_tc.cuh`` (and the headers they include) in one call.

    python3 scripts/time_ldmk_variants.py DIR [DIR ...]

Each DIR holds those sources (a copy of ``deformationpyramid_tpu_torch/
csrc`` with an edit, say); all of them are built at once, each alone into
``DIR/build`` with the package's own nvcc flags, and bound through this
tree's wrapper, so the C entry points must keep their signatures. For each
DIR it prints C5's device time (``chip_smoke.cuda_ms``, every call a step)
and its worst error of the step's m / (1 - b1) against the plain version
(of a tensor's max) at ``chip_smoke.ldmk_case``'s two shapes: 2048 rows
with 2000 valid and 4096 rows with 30 valid, each at the tile
``ldmk_tile`` chooses and at 16 and 32 rows a tile. A variant may leave
parts out to time the rest (its error then says so).
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
from deformationpyramid_tpu_torch.solve.loop import LoopConfig  # noqa: E402


def inputs(dev, cfg, rows, n_valid, seed):
    """ldmk_case's inputs: (flat, x, tgt, mask, count)."""
    src, _, _, s_l, t_l, valid = cs.landmark_rows(
        seed=seed, n=max(4000, rows + 1000), rows=rows, n_valid=n_valid)
    mean = src.mean(0)
    x = torch.from_numpy(s_l - mean).to(dev)
    tgt = torch.from_numpy(t_l - mean).to(dev)
    flat = pyramid.ravel(pyramid.params_from_numpy(
        cs.numpy_level_params(pyramid.level_shapes(cfg), seed=2),
        device=dev)).contiguous()
    keep = cs.off_kinks(flat, x, cs.MID_LEVEL, cfg)
    mask = (torch.from_numpy(valid).to(dev) & keep).float()
    return flat, x, tgt, mask, mask.sum().clamp_min(1.0)


def step(fn, flat, x, tgt, mask, count, cfg, lcfg, dev, scratch=None):
    stop = fi.EarlyStop(lcfg, dev)
    p, m, v = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
    aux = x.clone()
    args = (p, m, v, x, tgt, mask, count, stop, aux, cs.MID_LEVEL, cfg, 0.01)
    fn(*args, *(() if scratch is None else (scratch,)))
    return args, m


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    dirs = [Path(d).resolve() for d in sys.argv[1:]]
    print(f"built {len(dirs)} variants in "
          f"{cuda_lib.build_variants(dirs):.1f} s", flush=True)
    dev = torch.device("cuda")
    cfg = pyramid.NDPConfig(**cs.LNDP_PYRAMID)
    shapes = pyramid.level_shapes(cfg)
    cases = [(rows, valid, inputs(dev, cfg, rows, valid, seed))
             for rows, valid, seed in ((cs.LDMK_ROWS, cs.N_LDMK, 5),
                                       (cs.LNDP_ROWS, cs.LNDP_VALID, 6))]
    refs = [step(fi.ldmk_iteration_plain, *inp, cfg, LoopConfig(iters=500),
                 dev)[1] for _, _, inp in cases]
    never = LoopConfig(iters=10 ** 9, loss_eps=0.0, max_break_count=10 ** 9)
    chosen = fi.ldmk_tile
    c1 = 1.0 - fi.ADAM_B1
    for d in dirs:
        cuda_lib.use_variant(d)
        line = f"{d.name:16s}"
        for (rows, valid, inp), ref in zip(cases, refs):
            for tile in (None, 16, 32):
                fi.ldmk_tile = chosen if tile is None else \
                    (lambda n, pcfg, t=tile: t)
                tag = f"{rows}/{valid} tile {fi.ldmk_tile(rows, cfg)}"
                try:
                    _, m = step(fi.ldmk_iteration, *inp, cfg,
                                LoopConfig(iters=500), dev)
                    try:
                        err = cs.rel_grad_err(m / c1, ref / c1, shapes, tag,
                                              tol=1.0)
                    except AssertionError:
                        err = float("inf")
                    scratch = fi.ldmk_scratch(rows, cfg, dev)
                    args, _ = step(fi.ldmk_iteration, *inp, cfg, never, dev,
                                   scratch)
                    ms = cs.cuda_ms(lambda: fi.ldmk_iteration(*args,
                                                              scratch))
                    line += f" | {tag}: {ms:.4f} ms, err {err:.1e}"
                except (RuntimeError, ValueError) as exc:
                    line += f" | {tag}: not launched ({exc})"
        fi.ldmk_tile = chosen
        print(line, flush=True)


if __name__ == "__main__":
    main()
