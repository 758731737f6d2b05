#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises, so the script exits
non-zero and never prints the closing ``{"ok": true, ...}`` line:

1. device   the card's name and power limit (nvidia-smi); float32 matmuls
            at "highest" precision and no TF32 anywhere;
2. build    nvcc compiles deformationpyramid_tpu_torch/csrc/*.cu for sm_90a
            into build/torch_kernels/ (the time is printed);
3. kernels  each kernel (C1 nn_dual, C2 level_warp_fwd, C3 level_warp_bwd,
            C4 adam_step) at the main path's shapes (2000 points, width 128,
            depth 3, a mid level) against its plain PyTorch version on the
            same inputs, with the tolerance stated; the device time of
            each, by CUDA events (median of 30 calls);
4. fused    the bench configuration (9 levels, width 128, 500 iterations,
            2000 samples, SE3/axis_angle, fused iteration) on
            make_batch(4, n=2000, seed=100, deform=0.12) through
            register_pair, the first pair as warm-up: finite output, sane
            per-level iteration counts, full-cloud EPE >= 10x below the
            initial flow, and every kernel's launch count > 0;
5. unfused  one pair with use_fused_iteration=False (plain warp, autograd,
            truncated_chamfer on C1): the same checks, and C1 launched;
6. small    a small fused solve on the card against the same solve on the
            CPU, where every kernel's plain version runs: equal per-level
            iteration counts and warped points within 1e-3.

Then one JSON line with every kernel's launches, error and times, the
nvidia-smi line, and last the JSON result line. The script needs a CUDA
device and the repository around it, and uses no network.
"""
from __future__ import annotations

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

    # The chamfer gradient of the main path feeds C3.
    n_len = torch.tensor(2000.0, device=dev)
    _, g = fi._chamfer_glue(warped, got[1], got[3], y, xv, xv, n_len, n_len,
                            1e9)

    # C3: the parameter VJP, partials summed
    partials = fi.level_warp_bwd(flat, x, g, MID_LEVEL, cfg)
    ref_g = fi.level_warp_bwd_plain(flat, x, g, MID_LEVEL, cfg)[0]
    got_g = partials.sum(0)
    torch.cuda.synchronize()
    shapes = pyramid.level_shapes(cfg)
    gt, rt = pyramid.unravel(got_g, shapes), pyramid.unravel(ref_g, shapes)
    worst = 0.0
    for k in rt:
        for kk in rt[k]:
            scale = float(rt[k][kk].abs().max())
            rel = float((gt[k][kk] - rt[k][kk]).abs().max()) / max(scale, 1e-30)
            check(rel <= 1e-4, f"C3 {k}.{kk}: err {rel} of max|g| > 1e-4")
            worst = max(worst, rel)
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


def small_phase(dp, dev):
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.models import pyramid

    cfg = dp.SolverConfig(pyramid=dp.NDPConfig(m=3, k0=-6, width=32),
                          iters=30, samples=200, use_fused_iteration=True)
    src, tgt, _ = make_pair(n=260, seed=0, deform=0.12)
    rng = np.random.default_rng(0)
    s = torch.from_numpy(src[rng.permutation(260)[:200]] - src.mean(0))
    t = torch.from_numpy(tgt[rng.permutation(260)[:200]] - tgt.mean(0))
    valid = torch.ones(200, dtype=torch.bool)
    params = dp.init_pyramid_params(torch.Generator().manual_seed(7),
                                    cfg.pyramid)
    from deformationpyramid_tpu_torch.solve.registration import \
        optimize_pyramid
    res = {}
    for d in (dev, torch.device("cpu")):
        p, st = optimize_pyramid(pyramid.tree_map(lambda a: a.to(d), params),
                                 s.to(d), valid.to(d), t.to(d), valid.to(d),
                                 cfg)
        res[d.type] = (dp.warp(p, s.to(d), cfg.pyramid)[0].cpu(),
                       st["iters"].cpu().tolist())
    err = float((res["cuda"][0] - res["cpu"][0]).abs().max())
    check(res["cuda"][1] == res["cpu"][1],
          f"small: iterations {res['cuda'][1]} vs CPU {res['cpu'][1]}")
    check(err <= 1e-3, f"small: warped err {err} vs CPU > 1e-3")
    phase("small", f"card vs CPU plain: iterations {res['cuda'][1]} equal, "
          f"warped max abs err {err:.3e} (<= 1e-3)")


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
               fused_iteration.LEVEL_WARP_BWD, fused_iteration.ADAM_STEP]
    measured = kernel_phase(dp, dev)

    fused = slice_phase(dp, dev, kernels, fused=True, n_pairs=3)
    for k in kernels:
        check(fused["launches"][k.name] > 0,
              f"fused: kernel {k.name} was never launched")
    phase("fused", f"{fused['pairs_per_s']:.4f} pairs/s, "
          f"{fused['ms_per_iter']:.4f} ms/iter ({fused['iters']} iterations "
          f"in {fused['seconds']:.3f} s), launches {fused['launches']}; {smi}")

    unfused = slice_phase(dp, dev, kernels, fused=False, n_pairs=1)
    check(unfused["launches"]["nn_dual"] > 0,
          "unfused: kernel nn_dual was never launched")
    phase("unfused", f"{unfused['pairs_per_s']:.4f} pairs/s, "
          f"{unfused['ms_per_iter']:.4f} ms/iter, launches "
          f"{unfused['launches']}; {smi}")

    small_phase(dp, dev)

    sources = {"nn_dual": ("csrc/nn_dual.cu", "ops/knn.py:389"),
               "level_warp_fwd": ("csrc/level_warp.cu",
                                  "ops/fused_iteration.py:139"),
               "level_warp_bwd": ("csrc/level_warp.cu",
                                  "ops/fused_iteration.py:439"),
               "adam_step": ("csrc/adam.cu", "ops/fused_iteration.py:439")}
    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda",
         "source": f"deformationpyramid_tpu_torch/{sources[k.name][0]}",
         "replaces": f"deformationpyramid_tpu/{sources[k.name][1]}",
         "launches": fused["launches"][k.name],
         "max_abs_err": measured[k.name]["err"],
         "ms": measured[k.name]["ms"],
         "plain_ms": measured[k.name]["plain_ms"]} for k in kernels],
        "fused_pairs_per_s": fused["pairs_per_s"],
        "fused_ms_per_iter": fused["ms_per_iter"],
        "unfused_pairs_per_s": unfused["pairs_per_s"],
        "unfused_ms_per_iter": unfused["ms_per_iter"]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
