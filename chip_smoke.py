#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises, so the script exits
non-zero and never prints the closing ``{"ok": true, ...}`` line:

1. device   the card's name and power limit (nvidia-smi); float32 matmuls
            at "highest" precision and no TF32 anywhere;
2. build    nvcc compiles deformationpyramid_tpu_torch/csrc/*.cu for sm_90a,
            one process per source, all at once, into build/torch_kernels/
            (the time is printed);
3. kernels  each kernel at its path's shapes against its plain PyTorch
            version on the same inputs, with the tolerance stated, and the
            device time of each, by CUDA events (median of 30 calls): C1
            nn_dual, C2 level_warp_fwd, C6 scatter_rows, C3
            level_warp_bwd, C4 adam_step at the bench shapes (2000 points,
            width 128, depth 3, SE3 + axis_angle, a mid level); C2 and C3
            again at the shape-transfer shapes (6000 points, Sim3 + euler);
            C5 ldmk_iteration at 2048 landmark rows (2000 valid), one step
            and a held step;
4. fused    the bench configuration (9 levels, width 128, 500 iterations,
            2000 samples, SE3/axis_angle, fused iteration) on
            make_batch(4, n=2000, seed=100, deform=0.12) through
            register_pair, the first pair as warm-up: finite output, sane
            per-level iteration counts, full-cloud EPE >= 10x below the
            initial flow, and every kernel's launch count > 0;
5. repeat   one bench pair fused twice: equal per-level iterations and
            bit-equal warped output (the glue's scatter has a fixed order);
6. unfused  one pair with use_fused_iteration=False (plain warp, autograd,
            truncated_chamfer on C1): the same checks, and C1 launched;
7. shape    the Sim(3) shape-transfer demo (cli/shape_transfer.py
            register_meshes at DEMO_CFG: 9 levels, width 128, Sim3 + euler,
            6000 samples) on a synthetic torus mesh of 10,000 vertices and
            a Sim3 transform of it plus a smooth bend, each written with
            save_ply and read back with load_ply: finite output, sane
            per-level iterations, the mean nearest-neighbour distance from
            the warped vertices to the target >= 5x below the initial one,
            C1-C4 and C6 launched;
8. landmark config/LNDP.yaml's solver (10 levels, SE3, axis_angle, w_cd 0)
            on make_pair pairs with 2000 landmarks from the ground-truth
            flow plus 0.002 noise, padded to 2048 rows: fused through C5,
            then unfused, then w_cd 1.0 (trunc 0.25) fused through C1-C4;
            EPE >= 10x below the initial flow, each path's kernels
            launched, and C5's ms/iter against the unfused loop's;
9. small    small solves on the card against the same solves on the CPU,
            where every kernel's plain version runs (SE3 + axis_angle,
            Sim3 + euler, both landmark modes): equal per-level iteration
            counts and warped points within 1e-3.

Then one JSON line with every kernel's launches, error and times, the
nvidia-smi line, and last the JSON result line. The script needs a CUDA
device and the repository around it, and uses no network.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

BENCH_PYRAMID = dict(m=9, k0=-8, depth=3, width=128,
                     rotation_format="axis_angle", motion="SE3")
BENCH_SOLVER = dict(iters=500, lr=0.01, max_break_count=15,
                    break_threshold_ratio=0.001, samples=2000)
MID_LEVEL = 4
REPS = 30


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median device time of one call of ``fn``, by CUDA events.

    Before each timed call the stream is kept busy by a spin kernel for
    longer than the host takes to enqueue the call, so the events measure
    the call's kernels back to back on the device, not the host's launch
    latency (which the slice's ms/iter includes)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * (2.0 * host_s + 1e-3)))  # ~2 GHz cycles
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def numpy_level_params(shapes: dict, seed: int) -> dict:
    """Xavier-uniform weights and torch-default biases for one level, made
    with numpy in the JAX package's layout."""
    rng = np.random.default_rng(seed)
    out = {}
    for key in sorted(shapes):
        w_shape = shapes[key]["w"]
        fan_in, fan_out = w_shape[-2], w_shape[-1]
        lim = (6.0 / (fan_in + fan_out)) ** 0.5
        out[key] = {
            "w": rng.uniform(-lim, lim, w_shape).astype(np.float32),
            "b": rng.uniform(-fan_in ** -0.5, fan_in ** -0.5,
                             shapes[key]["b"]).astype(np.float32),
        }
    return out


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def kernel_phase(dp, dev):
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.models import pyramid
    from deformationpyramid_tpu_torch.ops import fused_iteration as fi
    from deformationpyramid_tpu_torch.ops import knn

    cfg = pyramid.NDPConfig(**BENCH_PYRAMID)
    src, tgt, _ = make_pair(n=2000, seed=0, deform=0.12)
    x = torch.from_numpy(src - src.mean(0)).to(dev)
    y = torch.from_numpy(tgt - tgt.mean(0)).to(dev)
    lvl = pyramid.params_from_numpy(
        numpy_level_params(pyramid.level_shapes(cfg), seed=0), device=dev)
    flat = pyramid.ravel(lvl).contiguous()
    check(flat.numel() == 34694, f"flat level has {flat.numel()} values")
    xv = torch.ones(2000, dtype=torch.bool, device=dev)
    results = {}

    # C2: the level warp
    warped = fi.level_warp_fwd(flat, x, MID_LEVEL, cfg)
    ref_w = fi._plain_warp(flat, x, MID_LEVEL, cfg)
    torch.cuda.synchronize()
    err = float((warped - ref_w).abs().max())
    check(err <= 1e-5, f"C2 level_warp_fwd max abs err {err} > 1e-5")
    results["level_warp_fwd"] = dict(
        err=err,
        ms=cuda_ms(lambda: fi.level_warp_fwd(flat, x, MID_LEVEL, cfg)),
        plain_ms=cuda_ms(lambda: fi._plain_warp(flat, x, MID_LEVEL, cfg)),
        tol="max abs 1e-5")

    # C1: both 1-NN directions, on the warped points as in the solver
    got = knn.nn_argmin_dual(warped, y, xv, xv)
    ref = knn.nn_argmin_dual_plain(warped, y, xv, xv)
    torch.cuda.synchronize()
    err = 0.0
    for q, db, (d, i), (rd, ri) in ((warped, y, got[:2], ref[:2]),
                                    (y, warped, got[2:], ref[2:])):
        err = max(err, float((d - rd).abs().max()))
        flips = i != ri
        if bool(flips.any()):
            dg = ((q[flips] - db[i[flips]]) ** 2).sum(-1)
            dr = ((q[flips] - db[ri[flips]]) ** 2).sum(-1)
            rel = float(((dg - dr).abs() / dr.clamp_min(1e-30)).max())
            check(rel < 3e-4, f"C1 index flip beyond a near-tie: rel {rel}")
    check(err <= 1e-5, f"C1 nn_dual distance err {err} > 1e-5")
    results["nn_dual"] = dict(
        err=err,
        ms=cuda_ms(lambda: knn.nn_argmin_dual(warped, y, xv, xv)),
        plain_ms=cuda_ms(lambda: knn.nn_argmin_dual_plain(warped, y, xv, xv)),
        tol="indices equal up to near-ties < 3e-4 rel; distances 1e-5")

    # C6: the glue's y->x scatter, on the sweep's indices, against its
    # plain version (index_add_ on the CPU: bit-equal); plain_ms is
    # index_add_ on the card, which adds with atomics.
    rarg = got[3]
    gy = (y - warped[rarg]) * 1e-3
    gx = (warped - y) * 1e-3
    out = fi.scatter_add_rows(gx.clone(), rarg, gy)
    ref_s = fi.scatter_add_rows(gx.cpu(), rarg.cpu(), gy.cpu())
    torch.cuda.synchronize()
    check(torch.equal(out.cpu(), ref_s), "C6 scatter_rows differs from "
          f"index_add_ on the CPU by {float((out.cpu() - ref_s).abs().max())}")
    buf = gx.clone()
    results["scatter_rows"] = dict(
        err=float((out.cpu() - ref_s).abs().max()),
        ms=cuda_ms(lambda: fi.scatter_add_rows(buf, rarg, gy)),
        plain_ms=cuda_ms(lambda: buf.index_add_(0, rarg, gy)),
        tol="bit-equal to index_add_ on the CPU")

    # The chamfer gradient of the main path feeds C3.
    n_len = torch.tensor(2000.0, device=dev)
    _, g = fi._chamfer_glue(warped, got[1], got[3], y, xv, xv, n_len, n_len,
                            1e9)

    # C3: the parameter VJP, partials summed
    partials = fi.level_warp_bwd(flat, x, g, MID_LEVEL, cfg)
    ref_g = fi.level_warp_bwd_plain(flat, x, g, MID_LEVEL, cfg)[0]
    got_g = partials.sum(0)
    torch.cuda.synchronize()
    worst = rel_grad_err(got_g, ref_g, pyramid.level_shapes(cfg), "C3")
    results["level_warp_bwd"] = dict(
        err=float((got_g - ref_g).abs().max()),
        ms=cuda_ms(lambda: fi.level_warp_bwd(flat, x, g, MID_LEVEL, cfg)),
        plain_ms=cuda_ms(lambda: fi.level_warp_bwd_plain(flat, x, g,
                                                         MID_LEVEL, cfg)),
        tol=f"1e-4 of each tensor's max|g| (worst {worst:.2e})")

    # C4: one Adam step from zero moments, then a held step
    zero = torch.zeros((), device=dev)
    outs = []
    for fn in (fi.adam_step, fi.adam_step_plain):
        p, m, v = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
        fn(p, m, v, partials, zero, zero, 0.01)
        outs.append((p, m, v))
    torch.cuda.synchronize()
    (p, m, v), (rp, rm, rv) = outs
    for name, a, b in (("m", m, rm), ("v", v, rv)):
        e = float((a - b).abs().max())
        check(e <= 1e-6 * float(b.abs().max()),
              f"C4 {name} err {e} > 1e-6 of max")
    big = got_g.abs() > 1e-3 * got_g.abs().max()
    err = float((p - rp)[big].abs().max())
    check(err <= 1e-6, f"C4 p err {err} > 1e-6 where |g| > 1e-3 max|g|")
    held = [flat.clone(), m.clone(), v.clone()]
    fi.adam_step(*held, partials, zero, torch.ones((), device=dev), 0.01)
    torch.cuda.synchronize()
    check(torch.equal(held[0], flat) and torch.equal(held[1], m)
          and torch.equal(held[2], v), "C4 did not hold with done = 1")
    pa, ma, va = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
    results["adam_step"] = dict(
        err=err,
        ms=cuda_ms(lambda: fi.adam_step(pa, ma, va, partials, zero, zero,
                                        0.01)),
        plain_ms=cuda_ms(lambda: fi.adam_step_plain(pa, ma, va, partials,
                                                    zero, zero, 0.01)),
        tol="m, v 1e-6 of max; p 1e-6 where |g| > 1e-3 max|g|; hold exact")
    for name, r in results.items():
        phase("kernels", f"{name}: max_abs_err {r['err']:.3e} ({r['tol']}); "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    return results


def solve_checks(tag, warped, src, flow, stats, iters_cap):
    check(bool(torch.isfinite(warped).all()), f"{tag}: non-finite output")
    it = stats["iters"].cpu()
    check(bool(((it >= 1) & (it <= iters_cap)).all()),
          f"{tag}: level iterations {it.tolist()} outside [1, {iters_cap}]")
    check(not bool((it <= 2).all()), f"{tag}: every level stopped at once")
    check(not bool((it == iters_cap).all()), f"{tag}: early stop never fired")
    epe = float((warped - src - flow).norm(dim=-1).mean())
    init = float(flow.norm(dim=-1).mean())
    check(epe * 10.0 <= init, f"{tag}: EPE {epe} not 10x below {init}")
    return epe, init, it.tolist()


def slice_phase(dp, dev, kernels, fused: bool, n_pairs: int):
    from deformationpyramid_tpu_torch.data.synthetic import make_batch

    cfg = dp.SolverConfig(pyramid=dp.NDPConfig(**BENCH_PYRAMID),
                          **BENCH_SOLVER, use_fused_iteration=fused)
    srcs, tgts, flows = make_batch(n_pairs + 1, n=2000, seed=100,
                                   deform=0.12)
    data = [tuple(torch.from_numpy(a[i]).to(dev) for a in (srcs, tgts, flows))
            for i in range(n_pairs + 1)]
    dp.register_pair(0, data[0][0], data[0][1], cfg)     # warm-up
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    outs = [dp.register_pair(i, s, t, cfg) for i, (s, t, _) in
            enumerate(data[1:], start=1)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    total_iters = 0
    tag = "fused" if fused else "unfused"
    for i, ((warped, stats), (s, _, f)) in enumerate(zip(outs, data[1:])):
        epe, init, it = solve_checks(tag, warped, s, f, stats,
                                     BENCH_SOLVER["iters"])
        total_iters += sum(it)
        phase(tag, f"pair {i + 1}: EPE {epe:.5f} (initial flow {init:.5f}), "
              f"iterations per level {it}")
    return dict(pairs_per_s=n_pairs / dt, ms_per_iter=dt * 1e3 / total_iters,
                seconds=dt, iters=total_iters, launches=launches)


def rel_grad_err(got, ref, shapes, what, tol=1e-4):
    """Largest error of each parameter tensor's gradient relative to that
    tensor's max |g|; fails above ``tol``."""
    from deformationpyramid_tpu_torch.models import pyramid

    gt, rt = pyramid.unravel(got, shapes), pyramid.unravel(ref, shapes)
    worst = 0.0
    for k in rt:
        for kk in rt[k]:
            scale = float(rt[k][kk].abs().max())
            rel = float((gt[k][kk] - rt[k][kk]).abs().max()) / max(scale, 1e-30)
            check(rel <= tol, f"{what} {k}.{kk}: err {rel} of max|g| > {tol}")
            worst = max(worst, rel)
    return worst


def sim3_kernel_phase(dp, dev):
    """C2 and C3 at the shape-transfer shapes: 6000 points, Sim3 + euler."""
    from deformationpyramid_tpu_torch.cli.shape_transfer import DEMO_CFG
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.models import pyramid
    from deformationpyramid_tpu_torch.ops import fused_iteration as fi

    cfg = DEMO_CFG.pyramid
    src, _, flow = make_pair(n=6000, seed=3, deform=0.12)
    x = torch.from_numpy(src - src.mean(0)).to(dev)
    shapes = pyramid.level_shapes(cfg)
    flat = pyramid.ravel(pyramid.params_from_numpy(
        numpy_level_params(shapes, seed=1), device=dev)).contiguous()
    check(flat.numel() == fi.level_param_count(cfg),
          f"Sim3 flat level has {flat.numel()} values")
    g = (torch.from_numpy(flow) * 1e-3).to(dev).contiguous()
    out = fi.level_warp_fwd(flat, x, MID_LEVEL, cfg)
    ref = fi._plain_warp(flat, x, MID_LEVEL, cfg)
    part = fi.level_warp_bwd(flat, x, g, MID_LEVEL, cfg).sum(0)
    ref_g = fi.level_warp_bwd_plain(flat, x, g, MID_LEVEL, cfg)[0]
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(err <= 1e-5, f"C2 Sim3+euler max abs err {err} > 1e-5")
    worst = rel_grad_err(part, ref_g, shapes, "C3 Sim3+euler")
    res = {
        "level_warp_fwd": dict(
            err=err, tol="max abs 1e-5",
            ms=cuda_ms(lambda: fi.level_warp_fwd(flat, x, MID_LEVEL, cfg)),
            plain_ms=cuda_ms(lambda: fi._plain_warp(flat, x, MID_LEVEL,
                                                    cfg))),
        "level_warp_bwd": dict(
            err=float((part - ref_g).abs().max()),
            tol=f"1e-4 of each tensor's max|g| (worst {worst:.2e})",
            ms=cuda_ms(lambda: fi.level_warp_bwd(flat, x, g, MID_LEVEL, cfg)),
            plain_ms=cuda_ms(lambda: fi.level_warp_bwd_plain(
                flat, x, g, MID_LEVEL, cfg)))}
    for name, r in res.items():
        phase("kernels", f"{name} [Sim3+euler, 6000 points]: max_abs_err "
              f"{r['err']:.3e} ({r['tol']}); kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms")
    return res


LNDP_PYRAMID = dict(m=10, k0=-8, depth=3, width=128,
                    rotation_format="axis_angle", motion="SE3")
LNDP_SOLVER = dict(iters=500, lr=0.01, max_break_count=15,
                   break_threshold_ratio=0.001, samples=2000, w_cd=0.0,
                   trunc_cd=0.25)
N_LDMK, LDMK_ROWS = 2000, 2048
# the kernels of a fused chamfer-mode iteration
CHAMFER_KERNELS = ("nn_dual", "level_warp_fwd", "scatter_rows",
                   "level_warp_bwd", "adam_step")


def landmark_rows(seed: int, n: int = 4000):
    """A make_pair pair with N_LDMK landmarks from the ground-truth flow
    plus 0.002 noise, padded to LDMK_ROWS rows (the padding rows invalid):
    (src, tgt, flow, src_ldmk, tgt_ldmk, ldmk_valid), numpy."""
    from deformationpyramid_tpu_torch.data.synthetic import make_pair

    src, tgt, flow = make_pair(n=n, seed=seed, deform=0.12)
    rng = np.random.default_rng(seed)
    li = rng.permutation(n)[:LDMK_ROWS]
    s_l = src[li]
    t_l = (src[li] + flow[li]
           + rng.normal(0.0, 0.002, (LDMK_ROWS, 3))).astype(np.float32)
    return src, tgt, flow, s_l, t_l, np.arange(LDMK_ROWS) < N_LDMK


def ldmk_kernel_phase(dp, dev):
    """C5 at 2048 landmark rows (2000 valid), LNDP's pyramid, a mid level:
    one step from fresh state and a held step, against its plain version."""
    from deformationpyramid_tpu_torch.models import pyramid
    from deformationpyramid_tpu_torch.ops import fused_iteration as fi
    from deformationpyramid_tpu_torch.solve.loop import LoopConfig

    cfg = pyramid.NDPConfig(**LNDP_PYRAMID)
    src, _, _, s_l, t_l, valid = landmark_rows(seed=5)
    mean = src.mean(0)
    x = torch.from_numpy(s_l - mean).to(dev)
    tgt = torch.from_numpy(t_l - mean).to(dev)
    mask = torch.from_numpy(valid.astype(np.float32)).to(dev)
    count = mask.sum().clamp_min(1.0)
    flat = pyramid.ravel(pyramid.params_from_numpy(
        numpy_level_params(pyramid.level_shapes(cfg), seed=2),
        device=dev)).contiguous()

    def run(fn, lcfg):
        stop = fi.EarlyStop(lcfg, dev)
        p, m, v = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
        aux = x.clone()
        fn(p, m, v, x, tgt, mask, count, stop, aux, MID_LEVEL, cfg, 0.01)
        return p, m, v, aux, stop

    lcfg = LoopConfig(iters=500)
    (p, m, v, aux, st), (rp, rm, rv, raux, rst) = (
        run(fi.ldmk_iteration, lcfg), run(fi.ldmk_iteration_plain, lcfg))
    torch.cuda.synchronize()
    err = float((aux - raux).abs().max())
    check(err <= 1e-5, f"C5 warped rows err {err} > 1e-5")
    lerr = abs(float(st.loss) - float(rst.loss))
    check(lerr <= 1e-6 * float(rst.loss), f"C5 loss err {lerr}")
    for k in ("counter", "done", "it", "applied"):
        check(float(getattr(st, k)) == float(getattr(rst, k)),
              f"C5 {k} {float(getattr(st, k))} vs "
              f"{float(getattr(rst, k))}")
    check(not bool(st.done) and int(st.applied) == 1, "C5 did not step")
    for name, a, b in (("m", m, rm), ("v", v, rv)):
        e = float((a - b).abs().max())
        check(e <= 1e-6 * float(b.abs().max()), f"C5 {name} err {e}")
    big = rm.abs() > 1e-3 * rm.abs().max()
    perr = float((p - rp)[big].abs().max())
    check(perr <= 1e-6, f"C5 p err {perr} where |m| > 1e-3 max|m|")
    held = run(fi.ldmk_iteration, LoopConfig(iters=500, loss_eps=1e9))
    torch.cuda.synchronize()
    check(bool(held[4].done) and torch.equal(held[0], flat)
          and not held[1].any() and not held[2].any()
          and int(held[4].it) == 1, "C5 did not hold with done set")

    # Timing: an early stop that never fires, so every call steps.
    never = LoopConfig(iters=10 ** 9, loss_eps=0.0, max_break_count=10 ** 9)
    states = {}
    for name in ("kernel", "plain"):
        stop = fi.EarlyStop(never, dev)
        states[name] = (flat.clone(), torch.zeros_like(flat),
                        torch.zeros_like(flat), stop, x.clone())
    scratch = fi.ldmk_scratch(LDMK_ROWS, cfg, dev)
    kp, km, kv, kst, kaux = states["kernel"]
    pp, pm, pv, pst, paux = states["plain"]
    res = dict(
        err=err, tol="rows 1e-5; loss 1e-6 rel; counter/done equal; m, v "
        "1e-6 of max; p 1e-6 where |m| > 1e-3 max|m|; held step exact",
        ms=cuda_ms(lambda: fi.ldmk_iteration(
            kp, km, kv, x, tgt, mask, count, kst, kaux, MID_LEVEL, cfg, 0.01,
            scratch)),
        plain_ms=cuda_ms(lambda: fi.ldmk_iteration_plain(
            pp, pm, pv, x, tgt, mask, count, pst, paux, MID_LEVEL, cfg,
            0.01)))
    phase("kernels", f"ldmk_iteration [{LDMK_ROWS} rows, {N_LDMK} valid]: "
          f"max_abs_err {err:.3e} ({res['tol']}); kernel {res['ms']:.4f} "
          f"ms, plain {res['plain_ms']:.4f} ms")
    return res


def repeat_phase(dp, dev):
    """One bench pair through the fused path twice: the same iterations per
    level and bit-equal output."""
    from deformationpyramid_tpu_torch.data.synthetic import make_batch

    cfg = dp.SolverConfig(pyramid=dp.NDPConfig(**BENCH_PYRAMID),
                          **BENCH_SOLVER, use_fused_iteration=True)
    srcs, tgts, _ = make_batch(2, n=2000, seed=100, deform=0.12)
    s, t = (torch.from_numpy(a[1]).to(dev) for a in (srcs, tgts))
    (w1, st1), (w2, st2) = (dp.register_pair(1, s, t, cfg) for _ in range(2))
    it1, it2 = st1["iters"].tolist(), st2["iters"].tolist()
    check(it1 == it2, f"repeat: iterations {it1} then {it2}")
    check(torch.equal(w1, w2), "repeat: warped output differs, max abs "
          f"{float((w1 - w2).abs().max())}")
    phase("repeat", f"bench pair fused twice: iterations {it1} both times, "
          "warped output bit-equal")


def torus_mesh(n_major: int = 100, n_minor: int = 100):
    """A triangulated torus (radii 0.5 and 0.2): vertices [V, 3], faces."""
    u = np.linspace(0, 2 * np.pi, n_major, endpoint=False)
    v = np.linspace(0, 2 * np.pi, n_minor, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    r = 0.5 + 0.2 * np.cos(vv)
    verts = np.stack([r * np.cos(uu), r * np.sin(uu), 0.2 * np.sin(vv)], -1)
    idx = np.arange(n_major * n_minor).reshape(n_major, n_minor)
    a, b = idx, np.roll(idx, -1, 0)
    c, d = np.roll(idx, -1, 1), np.roll(np.roll(idx, -1, 0), -1, 1)
    faces = np.concatenate([np.stack([a, b, d], -1).reshape(-1, 3),
                            np.stack([a, d, c], -1).reshape(-1, 3)])
    return verts.reshape(-1, 3).astype(np.float32), faces.astype(np.int32)


def sim3_bend(verts: np.ndarray) -> np.ndarray:
    """A Sim3 transform (0.15 rad about z, scale 1.05, offset) of a smoothly
    bent copy of ``verts``."""
    ang = 0.15
    rot = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                    [np.sin(ang), np.cos(ang), 0.0], [0.0, 0.0, 1.0]])
    bent = verts.copy()
    bent[:, 2] += 0.08 * np.sin(2.0 * verts[:, 0])
    return (1.05 * bent @ rot.T + [0.4, -0.2, 0.1]).astype(np.float32)


def mean_nn_dist(a: torch.Tensor, b: torch.Tensor) -> float:
    from deformationpyramid_tpu_torch.ops.knn import nn_argmin

    return float(torch.sqrt(nn_argmin(a, b)[0]).mean())


def shape_phase(dp, dev, kernels):
    from deformationpyramid_tpu_torch.cli import shape_transfer as st
    from deformationpyramid_tpu_torch.data.ply import (
        load_ply, save_ply, sample_points_uniformly)

    out_dir = REPO / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    verts, faces = torus_mesh()
    meshes = []
    for name, v in (("src", verts), ("tgt", sim3_bend(verts))):
        path = out_dir / f"{name}.ply"
        save_ply(str(path), v, faces)
        mesh = load_ply(str(path))
        check(mesh.vertices.shape == v.shape
              and np.array_equal(mesh.faces, faces)
              and float(np.abs(mesh.vertices - v).max()) <= 1e-6,
              f"shape: {name}.ply did not read back")
        meshes.append(mesh)
    cfg = st.DEMO_CFG
    src_pts = sample_points_uniformly(meshes[0], cfg.samples, seed=0)
    tgt_pts = sample_points_uniformly(meshes[1], cfg.samples, seed=1)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    warped, stats = st.register_meshes(src_pts, tgt_pts, meshes[0].vertices,
                                       cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    check(bool(torch.isfinite(warped).all()), "shape: non-finite output")
    it = stats["iters"].cpu()
    check(bool(((it >= 1) & (it <= cfg.iters)).all())
          and not bool((it <= 2).all()) and not bool((it == cfg.iters).all()),
          f"shape: level iterations {it.tolist()}")
    tgt_v = torch.from_numpy(meshes[1].vertices).to(dev)
    before = mean_nn_dist(torch.from_numpy(meshes[0].vertices).to(dev), tgt_v)
    after = mean_nn_dist(warped, tgt_v)
    check(after * 5.0 <= before,
          f"shape: NN distance {after} not 5x below {before}")
    for name in CHAMFER_KERNELS:
        check(launches[name] > 0, f"shape: kernel {name} never launched")
    iters = int(it.sum())
    phase("shape", f"{len(verts)} vertices, {cfg.samples} samples: mean NN "
          f"distance {before:.5f} -> {after:.5f}; iterations per level "
          f"{it.tolist()}; {dt:.3f} s, {dt * 1e3 / iters:.4f} ms/iter; "
          f"launches {launches}")
    return dict(seconds=dt, ms_per_iter=dt * 1e3 / iters, iters=iters,
                nn_before=before, nn_after=after, launches=launches)


def landmark_phase(dp, dev, kernels):
    """LNDP's solver: w_cd 0 through C5, then unfused, then w_cd 1 through
    C1-C4, on the same landmark pair (one warm-up pair through C5 first)."""
    base = dp.SolverConfig(pyramid=dp.NDPConfig(**LNDP_PYRAMID),
                           **LNDP_SOLVER)
    modes = {
        "C5": dict(use_fused_iteration=True, use_fused_ldmk=True),
        "unfused": dict(use_fused_iteration=False),
        "ldmk+cd": dict(use_fused_iteration=True, w_cd=1.0),
    }
    needs = {"C5": ["ldmk_iteration"], "unfused": ["adam_step"],
             "ldmk+cd": CHAMFER_KERNELS}

    def tensors(seed):
        return [torch.from_numpy(np.asarray(a)).to(dev)
                for a in landmark_rows(seed)]

    src, tgt, _, s_l, t_l, lv = tensors(300)
    dp.register_pair(0, src, tgt, dataclasses.replace(base, **modes["C5"]),
                     src_ldmk=s_l, tgt_ldmk=t_l, ldmk_valid=lv)
    src, tgt, flow, s_l, t_l, lv = tensors(301)
    out = {}
    for name, knobs in modes.items():
        cfg = dataclasses.replace(base, **knobs)
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        warped, stats = dp.register_pair(1, src, tgt, cfg, src_ldmk=s_l,
                                         tgt_ldmk=t_l, ldmk_valid=lv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        epe, init, it = solve_checks(f"landmark {name}", warped, src, flow,
                                     stats, cfg.iters)
        for kn in needs[name]:
            check(launches[kn] > 0, f"landmark {name}: {kn} never launched")
        out[name] = dict(epe=epe, init=init, iters=it, seconds=dt,
                         ms_per_iter=dt * 1e3 / sum(it), launches=launches)
        phase("landmark", f"{name}: EPE {epe:.5f} (initial flow "
              f"{init:.5f}), iterations per level {it}, {dt:.3f} s, "
              f"{dt * 1e3 / sum(it):.4f} ms/iter, launches {launches}")
    return out


def small_phase(dp, dev):
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.models import pyramid
    from deformationpyramid_tpu_torch.solve.registration import \
        optimize_pyramid

    small = dict(m=3, width=32)
    cases = {
        "SE3+axis_angle": (dict(small, k0=-6), {}),
        "Sim3+euler": (dict(small, k0=-6, motion="Sim3",
                            rotation_format="euler"), {}),
        "landmark C5": (dict(small, k0=-8),
                        dict(w_cd=0.0, use_fused_ldmk=True)),
        "landmark+chamfer": (dict(small, k0=-8), dict(w_cd=1.0)),
    }
    src, tgt, flow = make_pair(n=260, seed=0, deform=0.12)
    rng = np.random.default_rng(0)
    s = torch.from_numpy(src[rng.permutation(260)[:200]] - src.mean(0))
    t = torch.from_numpy(tgt[rng.permutation(260)[:200]] - tgt.mean(0))
    li = rng.permutation(260)[:48]
    s_l = torch.from_numpy(src[li] - src.mean(0))
    t_l = torch.from_numpy(src[li] + flow[li] - tgt.mean(0))
    l_valid = torch.arange(48) < 40
    valid = torch.ones(200, dtype=torch.bool)
    for name, (pk, knobs) in cases.items():
        cfg = dp.SolverConfig(pyramid=dp.NDPConfig(**pk), iters=30,
                              samples=200, use_fused_iteration=True, **knobs)
        n_ldmk, pts, pv = 0, s, valid
        if "w_cd" in knobs:
            n_ldmk = 48
            pts, pv = ((torch.cat([s_l, s]), torch.cat([l_valid, valid]))
                       if knobs["w_cd"] > 0 else (s_l, l_valid))
        params = dp.init_pyramid_params(torch.Generator().manual_seed(7),
                                        cfg.pyramid)
        res = {}
        for d in (dev, torch.device("cpu")):
            p, st = optimize_pyramid(
                pyramid.tree_map(lambda a: a.to(d), params), pts.to(d),
                pv.to(d), t.to(d), valid.to(d), cfg, n_ldmk,
                t_l.to(d) if n_ldmk else None,
                l_valid.to(d) if n_ldmk else None)
            res[d.type] = (dp.warp(p, s.to(d), cfg.pyramid)[0].cpu(),
                           st["iters"].cpu().tolist())
        err = float((res["cuda"][0] - res["cpu"][0]).abs().max())
        check(res["cuda"][1] == res["cpu"][1],
              f"small {name}: iterations {res['cuda'][1]} vs CPU "
              f"{res['cpu'][1]}")
        check(err <= 1e-3, f"small {name}: warped err {err} vs CPU > 1e-3")
        phase("small", f"{name}: card vs CPU plain: iterations "
              f"{res['cuda'][1]} equal, warped max abs err {err:.3e} "
              "(<= 1e-3)")


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; the port's main path "
                           "runs only on a GPU")
    sys.path.insert(0, str(REPO))
    import deformationpyramid_tpu_torch as dp
    from deformationpyramid_tpu_torch.ops import cuda_lib, fused_iteration, knn

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls enabled")
    torch.backends.cudnn.allow_tf32 = False
    phase("device", f"{torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; fp32 highest, "
          "no TF32")

    path, secs = cuda_lib.build()
    cuda_lib.load()
    phase("build", f"nvcc {secs:.1f} s -> {path.relative_to(REPO)}")

    kernels = [knn.NN_DUAL, fused_iteration.LEVEL_WARP_FWD,
               fused_iteration.SCATTER_ROWS, fused_iteration.LEVEL_WARP_BWD,
               fused_iteration.ADAM_STEP, fused_iteration.LDMK_ITERATION]
    measured = kernel_phase(dp, dev)
    sim3 = sim3_kernel_phase(dp, dev)
    measured["ldmk_iteration"] = ldmk_kernel_phase(dp, dev)

    fused = slice_phase(dp, dev, kernels, fused=True, n_pairs=3)
    for name in CHAMFER_KERNELS:
        check(fused["launches"][name] > 0,
              f"fused: kernel {name} was never launched")
    phase("fused", f"{fused['pairs_per_s']:.4f} pairs/s, "
          f"{fused['ms_per_iter']:.4f} ms/iter ({fused['iters']} iterations "
          f"in {fused['seconds']:.3f} s), launches {fused['launches']}; {smi}")

    repeat_phase(dp, dev)

    unfused = slice_phase(dp, dev, kernels, fused=False, n_pairs=1)
    check(unfused["launches"]["nn_dual"] > 0,
          "unfused: kernel nn_dual was never launched")
    phase("unfused", f"{unfused['pairs_per_s']:.4f} pairs/s, "
          f"{unfused['ms_per_iter']:.4f} ms/iter, launches "
          f"{unfused['launches']}; {smi}")

    shape = shape_phase(dp, dev, kernels)
    landmark = landmark_phase(dp, dev, kernels)
    phase("landmark", f"C5 {landmark['C5']['ms_per_iter']:.4f} ms/iter "
          f"against the unfused loop's "
          f"{landmark['unfused']['ms_per_iter']:.4f} ms/iter; {smi}")

    small_phase(dp, dev)

    sources = {"nn_dual": ("csrc/nn_dual.cu", "ops/knn.py:389"),
               "level_warp_fwd": ("csrc/level_warp.cu",
                                  "ops/fused_iteration.py:139"),
               "level_warp_bwd": ("csrc/level_warp.cu",
                                  "ops/fused_iteration.py:439"),
               "adam_step": ("csrc/adam.cu", "ops/fused_iteration.py:439"),
               "scatter_rows": ("csrc/scatter_rows.cu",
                                "ops/fused_iteration.py:431"),
               "ldmk_iteration": ("csrc/ldmk_iteration.cu",
                                  "ops/fused_iteration.py:1002")}
    path_launches = dict(fused["launches"],
                         ldmk_iteration=landmark["C5"]["launches"][
                             "ldmk_iteration"])
    rows = []
    for k in kernels:
        row = {"name": k.name, "route": "cuda",
               "source": f"deformationpyramid_tpu_torch/{sources[k.name][0]}",
               "replaces": f"deformationpyramid_tpu/{sources[k.name][1]}",
               "launches": path_launches[k.name],
               "max_abs_err": measured[k.name]["err"],
               "ms": measured[k.name]["ms"],
               "plain_ms": measured[k.name]["plain_ms"]}
        if k.name in sim3:
            row["sim3_euler"] = {key: sim3[k.name][key]
                                 for key in ("err", "ms", "plain_ms")}
        rows.append(row)
    print(json.dumps({
        "kernels": rows,
        "fused_pairs_per_s": fused["pairs_per_s"],
        "fused_ms_per_iter": fused["ms_per_iter"],
        "unfused_pairs_per_s": unfused["pairs_per_s"],
        "unfused_ms_per_iter": unfused["ms_per_iter"],
        "shape_transfer": shape,
        "landmark": landmark}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
