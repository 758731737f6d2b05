#!/usr/bin/env python3
"""Kernels C2 level_warp_fwd and C3 level_warp_bwd alone on one CUDA GPU,
with C4 adam_step and C13 sum_partials at the partial rows C3 writes, and
the bits of C2 and C5.

    python3 scripts/check_torch_level_warp.py [OUT_DIR]

At every case of the targets (2000 points at width 128 / depth 3 for SE3
+ axis_angle, SE3 + quaternion, SE3 + 6D, sflow and the nonrigidity head at
level 1; 6000 points for Sim3 + euler) it checks C2 against its plain
version (max abs 1e-5 on the warp and the nonrigidity, a second launch
bit-equal) and C3 against its plain version (1e-4 of each tensor's max
|g|), and prints the device times (CUDA events, median of 30,
``chip_smoke.cuda_ms``) of C2 and C3 beside the plain versions', their
3xTF32 tensor-core bounds and their f32 bounds, the sha256 of C3's partial
rows, C3's row count, C4's and C13's times at those rows and C3 + C4 in one
timed call. Where the wrapper chooses C3's tile (``bwd_tile``) it also
times C3 and C3 + C4 at other tiles, and where it chooses C2's
(``fwd_tile``), C2 at other tiles, whose warp must be bit-equal. It prints
the sha256 of C2's and C5's outputs on fixed inputs
(``chip_smoke.c2_c5_digests``) and, where the build reports it, ptxas's
registers and spill bytes of C3's 18 instantiations. Run it in this tree
and in the parent's through ``scripts/ab_kernels.sh`` to compare both in
one call. Writes ``OUT_DIR/check_torch_level_warp.json`` (default
``build/profile``); exits non-zero if a check failed.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from deformationpyramid_tpu_torch.data.synthetic import make_pair  # noqa: E402
from deformationpyramid_tpu_torch.models import pyramid  # noqa: E402
from deformationpyramid_tpu_torch.ops import cuda_lib, knn  # noqa: E402
from deformationpyramid_tpu_torch.ops import fused_iteration as fi  # noqa: E402

TILES = (16, 32, 48, 64)


def cases(dev):
    """(tag, cfg, flat, x, g, g_nr, level) at the target table's shapes,
    with chip_smoke.py's inputs: zero cotangents at the ReLUs' kinks
    (``chip_smoke.off_kinks``). The chamfer gradient comes from the plain
    warp, so that C3's inputs, and so its bits, do not depend on C2's."""
    out = []
    src, tgt, flow = make_pair(n=2000, seed=0, deform=0.12)
    x = torch.from_numpy(src - src.mean(0)).to(dev)
    y = torch.from_numpy(tgt - tgt.mean(0)).to(dev)
    cfg = pyramid.NDPConfig(**cs.BENCH_PYRAMID)
    flat = pyramid.ravel(pyramid.params_from_numpy(
        cs.numpy_level_params(pyramid.level_shapes(cfg), seed=0),
        device=dev)).contiguous()
    warped = fi._plain_warp(flat, x, cs.MID_LEVEL, cfg)
    _, cidx, _, rarg = knn.nn_argmin_dual(warped, y)
    ones = torch.ones(2000, dtype=torch.bool, device=dev)
    n_len = torch.tensor(2000.0, device=dev)
    _, g = fi._chamfer_glue(warped, cidx, rarg, y, ones, ones, n_len, n_len,
                            1e9)
    out.append(("SE3+axis_angle, 2000", cfg, flat, x, g, None, cs.MID_LEVEL))
    g_bench = g
    gf = (torch.from_numpy(flow) * 1e-3).to(dev).contiguous()
    for i, (motion, fmt) in enumerate(cs.NEW_FORMATS[:3]):
        c = pyramid.NDPConfig(**dict(cs.BENCH_PYRAMID, motion=motion,
                                     rotation_format=fmt))
        f = pyramid.ravel(pyramid.params_from_numpy(
            cs.numpy_level_params(pyramid.level_shapes(c), seed=10 + i),
            device=dev)).contiguous()
        out.append((f"{motion}+{fmt}, 2000", c, f, x, gf, None,
                    cs.MID_LEVEL))
    c = pyramid.NDPConfig(**cs.BENCH_PYRAMID, nonrigidity_est=True)
    f = pyramid.ravel(pyramid.params_from_numpy(
        cs.numpy_level_params(pyramid.level_shapes(c), seed=21),
        device=dev)).contiguous()
    g_nr = (torch.from_numpy(np.random.default_rng(5).standard_normal(2000))
            * 1e-2).float().to(dev)
    out.append(("nonrigid level 1, 2000", c, f, x, g_bench, g_nr, 1))
    from deformationpyramid_tpu_torch.cli.shape_transfer import DEMO_CFG

    c = DEMO_CFG.pyramid
    src6, _, flow6 = make_pair(n=6000, seed=3, deform=0.12)
    f = pyramid.ravel(pyramid.params_from_numpy(
        cs.numpy_level_params(pyramid.level_shapes(c), seed=1),
        device=dev)).contiguous()
    out.append(("Sim3+euler, 6000", c, f,
                torch.from_numpy(src6 - src6.mean(0)).to(dev),
                (torch.from_numpy(flow6) * 1e-3).to(dev).contiguous(), None,
                cs.MID_LEVEL))
    masked = []
    for tag, c, f, x_, g_, g_nr_, level in out:
        keep = cs.off_kinks(f, x_, level, c)
        masked.append((tag, c, f, x_, g_ * keep[:, None],
                       None if g_nr_ is None else g_nr_ * keep, level))
    return masked


def time_case(dev, cfg, flat, x, g, g_nr, level, tile=None):
    """C3 (at ``tile`` points a block where given: ``fi.bwd_tile``
    replaced meanwhile), C4 and C13 at its rows, and C3 + C4."""
    chosen = fi.bwd_tile if tile is not None else None
    if tile is not None:
        fi.bwd_tile = lambda n, pcfg: tile

    def c3():
        return fi.level_warp_bwd(flat, x, g, level, cfg, g_nr)

    try:
        partials = c3()
        zero = torch.zeros((), device=dev)
        p, m, v = (flat.clone(), torch.zeros_like(flat),
                   torch.zeros_like(flat))
        rows = partials.shape[0]
        res = dict(rows=rows, ms=cs.cuda_ms(c3),
                   c4_ms=cs.cuda_ms(lambda: fi.adam_step(
                       p, m, v, partials, zero, zero, 0.01)),
                   c13_ms=cs.cuda_ms(lambda: fi.sum_partials(partials)),
                   c3_c4_ms=cs.cuda_ms(lambda: fi.adam_step(
                       p, m, v, c3(), zero, zero, 0.01)))
    finally:
        if chosen is not None:
            fi.bwd_tile = chosen
    res.update(cs.level_bounds(x.shape[0], cfg, flat.numel(),
                               rows)["level_warp_bwd"])
    return res


def c2_case(cfg, flat, x, level, tile=None):
    """C2 (at ``tile`` points a block where given: ``fi.fwd_tile``
    replaced meanwhile): its outputs (the warp, and nr with the head) and
    its time."""
    chosen = fi.fwd_tile if tile is not None else None
    if tile is not None:
        fi.fwd_tile = lambda n, pcfg: tile

    def c2():
        if cfg.nonrigidity_est:
            return fi.level_warp_fwd_nr(flat, x, level, cfg)
        return (fi.level_warp_fwd(flat, x, level, cfg),)

    try:
        return c2(), c2(), cs.cuda_ms(c2)
    finally:
        if chosen is not None:
            fi.fwd_tile = chosen


def check_c2(tag, cfg, flat, x, level, failures):
    """C2 against its plain version (max abs 1e-5), a second launch and,
    where the tile is the wrapper's choice, every tile of ``TILES``
    bit-equal; its times and bounds."""
    got, again, ms = c2_case(cfg, flat, x, level)
    ref = fi._plain_warp_nr(flat, x, level, cfg)
    torch.cuda.synchronize()
    res = dict(ms=ms, plain_ms=cs.cuda_ms(
        lambda: fi._plain_warp_nr(flat, x, level, cfg)))
    try:
        res["err"] = max(float((a - b).abs().max())
                         for a, b in zip(got, ref) if b is not None)
        cs.check(res["err"] <= 1e-5, f"C2 {tag}: max abs err {res['err']}")
        cs.check(all(torch.equal(a, b) for a, b in zip(got, again)),
                 f"C2 {tag}: a second launch differs")
        if hasattr(fi, "fwd_tile"):
            res["tiles"] = {}
            for t in TILES:
                out, _, t_ms = c2_case(cfg, flat, x, level, tile=t)
                cs.check(all(torch.equal(a, b) for a, b in zip(got, out)),
                         f"C2 {tag}: tile {t} differs")
                res["tiles"][t] = t_ms
    except AssertionError as exc:
        failures.append(str(exc))
        print(f"FAILED: {exc}", flush=True)
    res.update(cs.level_bounds(x.shape[0], cfg, flat.numel(),
                               0)["level_warp_fwd"])
    return res


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else REPO / "build/profile"
    out.mkdir(parents=True, exist_ok=True)
    _, secs = cuda_lib.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"build {secs:.1f} s; {smi}", flush=True)
    dev = torch.device("cuda")
    report = dict(card=smi, failures=[])
    if hasattr(cuda_lib, "ptxas_log"):
        report["c3_ptxas"] = cs.c3_ptxas()
        (out / "ptxas.txt").write_text(cuda_lib.ptxas_log())
        for r in report["c3_ptxas"]:
            print(f"C3 ptxas {r}", flush=True)
    report["digests"] = cs.c2_c5_digests(dev)
    print("digests " + json.dumps(report["digests"]), flush=True)
    tiles = hasattr(fi, "bwd_tile")
    report["cases"] = {}
    for tag, cfg, flat, x, g, g_nr, level in cases(dev):
        part = fi.level_warp_bwd(flat, x, g, level, cfg, g_nr)
        again = fi.level_warp_bwd(flat, x, g, level, cfg, g_nr)
        ref = fi.level_warp_bwd_plain(flat, x, g, level, cfg, g_nr)[0]
        torch.cuda.synchronize()
        res = {}
        try:
            res["rel_err"] = cs.rel_grad_err(part.sum(0), ref,
                                             pyramid.level_shapes(cfg),
                                             f"C3 {tag}")
            cs.check(torch.equal(part, again), f"C3 {tag}: a second launch "
                     "differs")
        except AssertionError as exc:
            report["failures"].append(str(exc))
            print(f"FAILED: {exc}", flush=True)
        res.update(time_case(dev, cfg, flat, x, g, g_nr, level))
        res["plain_ms"] = cs.cuda_ms(lambda: fi.level_warp_bwd_plain(
            flat, x, g, level, cfg, g_nr))
        if tiles:
            res["tiles"] = {t: time_case(dev, cfg, flat, x, g, g_nr, level,
                                         tile=t) for t in TILES}
        res["sha256"] = cs.sha256_of(part)
        res["c2"] = c2 = check_c2(tag, cfg, flat, x, level,
                                  report["failures"])
        report["cases"][tag] = res
        print(f"C2 [{tag}]: {c2['ms']:.4f} ms (plain {c2['plain_ms']:.4f}; "
              f"bound {c2['bound_ms']:.5f} 3xTF32, {c2['f32_bound_ms']:.5f} "
              f"f32); err {c2.get('err', float('nan')):.2e}; tiles "
              + ", ".join(f"{t}: {m:.4f}" for t, m in
                          c2.get("tiles", {}).items()) + f"; {smi}",
              flush=True)
        print(f"C3 [{tag}]: {res['ms']:.4f} ms ({res['rows']} rows; plain "
              f"{res['plain_ms']:.4f}; bound {res['bound_ms']:.5f} 3xTF32, "
              f"{res['f32_bound_ms']:.5f} f32); C4 {res['c4_ms']:.4f}, C13 "
              f"{res['c13_ms']:.4f}, C3 + C4 {res['c3_c4_ms']:.4f} ms; err "
              f"{res.get('rel_err', float('nan')):.2e} of max|g|; sha256 "
              f"{res['sha256'][:16]}; {smi}",
              flush=True)
        for t, r in res.get("tiles", {}).items():
            print(f"    tile {t}: C3 {r['ms']:.4f} ms ({r['rows']} rows), "
                  f"C4 {r['c4_ms']:.4f}, C3 + C4 {r['c3_c4_ms']:.4f}",
                  flush=True)
    (out / "check_torch_level_warp.json").write_text(json.dumps(report,
                                                                indent=1))
    print(json.dumps(report), flush=True)
    if report["failures"]:
        raise SystemExit(f"{len(report['failures'])} check(s) failed")


if __name__ == "__main__":
    main()
