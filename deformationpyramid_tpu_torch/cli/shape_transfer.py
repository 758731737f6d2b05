"""Sim(3) shape-transfer demo (reference ``shape_transfer.py``).

Counterpart of ``deformationpyramid_tpu/cli/shape_transfer.py``. Registers
two mesh surfaces with a Sim3 deformation pyramid and warps the source mesh
vertices through the fitted pyramid. No Open3D: the PLY I/O and the
area-weighted surface sampling are ``data/ply.py``.

Usage:
  python -m deformationpyramid_tpu_torch.cli.shape_transfer -s src.ply \
      -t tgt.ply [-o out.ply] [--samples N] [--device cuda|cpu]

Runs on the card (``--device cuda``) unless the CPU is asked for.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..data.ply import PlyMesh, load_ply, save_ply, sample_points_uniformly
from ..models.pyramid import NDPConfig, init_pyramid_params, warp
from ..solve.registration import SolverConfig, optimize_pyramid
from ..utils import timers

# reference shape_transfer.py:27-49 hardcoded config
DEMO_CFG = SolverConfig(
    pyramid=NDPConfig(m=9, k0=-8, depth=3, width=128,
                      rotation_format="euler", motion="Sim3"),
    iters=500, lr=0.01, max_break_count=15, break_threshold_ratio=0.001,
    samples=6000,
)


def register_meshes(src_pts, tgt_pts, vertices, cfg: SolverConfig = DEMO_CFG,
                    seed: int = 0, device: torch.device | str = "cuda",
                    params: dict | None = None,
                    on_level: Callable | None = None):
    """Fit the pyramid on sampled surface points, warp arbitrary vertices.

    Mirrors the reference flow (``shape_transfer.py:104-168``): mean-centre,
    optimize every level on all the samples (no subsampling in the demo),
    then warp the mesh vertices through all fitted levels and translate
    them into the target frame. ``device`` defaults to ``cuda``, the
    port's entry points run on the card unless the caller asks for the CPU;
    the fused iteration (kernels C1-C4, Sim3 + euler) is on by default
    there. ``params`` (stacked, as ``init_pyramid_params`` makes them)
    replace the initial weights drawn from ``seed``. ``on_level`` is
    handed to :func:`optimize_pyramid`. The level loops and the vertex warp
    run inside the span ``dp::solve``, the name ``register_pair`` gives the
    same work. Returns (warped vertices [V, 3], stats {"iters": [m],
    "loss": [m]}).
    """
    device = torch.device(device)
    if cfg.use_fused_iteration is None:
        cfg = dataclasses.replace(cfg,
                                  use_fused_iteration=device.type == "cuda")
    pcfg = cfg.pyramid
    src, tgt, verts = (torch.as_tensor(np.asarray(a, np.float32),
                                       device=device)
                       for a in (src_pts, tgt_pts, vertices))
    if params is None:
        params = init_pyramid_params(torch.Generator().manual_seed(seed),
                                     pcfg, device=device)
    with timers.span("dp::solve"):
        src_mean = src.mean(0, keepdim=True)
        tgt_mean = tgt.mean(0, keepdim=True)
        valid_n = torch.ones(src.shape[0], dtype=torch.bool, device=device)
        valid_m = torch.ones(tgt.shape[0], dtype=torch.bool, device=device)
        final, stats = optimize_pyramid(params, src - src_mean, valid_n,
                                        tgt - tgt_mean, valid_m, cfg,
                                        on_level=on_level)
        with torch.no_grad():
            warped, _ = warp(final, verts - src_mean, pcfg)
        return warped + tgt_mean, stats


def transfer_meshes(src_mesh: PlyMesh, tgt_mesh: PlyMesh,
                    cfg: SolverConfig = DEMO_CFG, seed: int = 0,
                    device: torch.device | str = "cuda",
                    on_level: Callable | None = None):
    """One shape transfer, what :func:`main` does between loading and
    saving: ``cfg.samples`` area-weighted surface samples of each mesh
    (the source's drawn with ``seed``, the target's with ``seed + 1``;
    span ``dp::shape_transfer.sample``), :func:`register_meshes` with the
    initial weights drawn from ``seed``, and the source's warped vertices
    copied to the host. Returns (warped vertices [V, 3] as a float32
    numpy array, stats {"iters": [m], "loss": [m]})."""
    with timers.span("dp::shape_transfer.sample"):
        src_pts = sample_points_uniformly(src_mesh, cfg.samples, seed=seed)
        tgt_pts = sample_points_uniformly(tgt_mesh, cfg.samples,
                                          seed=seed + 1)
    warped, stats = register_meshes(src_pts, tgt_pts, src_mesh.vertices, cfg,
                                    seed=seed, device=device,
                                    on_level=on_level)
    return warped.cpu().numpy(), stats


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-s", required=True, help="Path to the src mesh (.ply)")
    ap.add_argument("-t", required=True, help="Path to the tgt mesh (.ply)")
    ap.add_argument("-o", default=None, help="Output warped mesh path")
    ap.add_argument("--samples", type=int, default=DEMO_CFG.samples)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solve (default cuda)")
    args = ap.parse_args(argv)

    src_mesh = load_ply(args.s)
    tgt_mesh = load_ply(args.t)
    cfg = dataclasses.replace(DEMO_CFG, samples=args.samples)

    t0 = time.perf_counter()
    warped_verts, stats = transfer_meshes(src_mesh, tgt_mesh, cfg, seed=0,
                                          device=args.device)
    dt = time.perf_counter() - t0
    print(f"registered in {dt:.2f}s; iters/level = "
          f"{stats['iters'].tolist()}")
    print(f"final level losses = "
          f"{np.round(stats['loss'].cpu().numpy(), 5).tolist()}")
    if args.o:
        save_ply(args.o, warped_verts, src_mesh.faces)
        print(f"wrote {args.o}")


if __name__ == "__main__":
    main()
