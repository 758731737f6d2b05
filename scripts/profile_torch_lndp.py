"""Where the time of the learned landmark path goes, on a CUDA GPU.

    python scripts/profile_torch_lndp.py [--out DIR] [--points N]

Builds the full-width landmark model of ``config/LNDP.yaml`` (weights from
seed 0, ``attention_impl='flash'``), collates one ``make_pair(n=8000,
deform=0.08)`` pair, and times the stages of ``landmark_inference`` apart
(backbone, transformer, matching, soft Procrustes, NeCo), each ending in a
synchronise, median of 5. Then one whole ``landmark_inference`` under
``torch.profiler``: device time per kernel name, the device-busy share of
the window, and the Chrome trace in ``--out``. Last the landmark solve:
``register_pair`` with ``config/LNDP.yaml``'s solver through C5 on that
pair's landmarks (padded to the matcher's cap, at least 2048 rows, as
``chip_smoke.py``'s lndp phase pads them), its host ms/iter (median of 3
solves), and one solve under ``torch.profiler``: C5's device time a
launch and the device-busy share of the solve's window. Needs a CUDA
device; imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def timed(fn, reps=5):
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile",
                    help="directory for the Chrome trace")
    ap.add_argument("--points", type=int, default=8000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    sys.path.insert(0, str(REPO))
    from deformationpyramid_tpu_torch.data.collate import (
        build_pair_pyramid, calibrate_neighborhood_limits, pow2_cap,
        pyramid_to_device)
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.match import attention as att
    from deformationpyramid_tpu_torch.match import landmark as lm
    from deformationpyramid_tpu_torch.match.backbone import (
        KPFCN_ARCHITECTURE, apply_kpfcn_coarse)
    from deformationpyramid_tpu_torch.match.config_loader import \
        landmark_config_from_yaml
    from deformationpyramid_tpu_torch.match.matching import (
        confidence_matrix, extract_matches_all)
    from deformationpyramid_tpu_torch.match.pipeline import split_coarse
    from deformationpyramid_tpu_torch.match.procrustes import soft_procrustes
    from deformationpyramid_tpu_torch.match.transformer import \
        apply_transformer

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    lcfg = landmark_config_from_yaml(
        str(REPO / "config" / "configs" / "correspondence.yaml"))
    m = lcfg.matcher
    lcfg = dataclasses.replace(lcfg, matcher=dataclasses.replace(
        m, transformer=dataclasses.replace(m.transformer,
                                           attention_impl="flash")))
    mcfg = lcfg.matcher
    params = lm.init_landmark_model(torch.Generator().manual_seed(0), lcfg,
                                    device=dev)
    src, tgt, _ = make_pair(n=args.points, seed=400, deform=0.08)
    t0 = time.perf_counter()
    limits = calibrate_neighborhood_limits([(src, tgt)], mcfg.kpfcn,
                                           KPFCN_ARCHITECTURE)
    t1 = time.perf_counter()
    pyr = build_pair_pyramid(src, tgt, mcfg.kpfcn, KPFCN_ARCHITECTURE,
                             limits, pad_to="pow2")
    t2 = time.perf_counter()
    pyrd = pyramid_to_device(pyr, dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    cl = mcfg.coarse_level
    sl, tl = pyr.src_lengths[cl], pyr.tgt_lengths[cl]

    s_cap, t_cap = pow2_cap(sl), pow2_cap(tl)
    print(f"calibrate {t1 - t0:.3f} s, build_pair_pyramid {t2 - t1:.3f} s, "
          f"to device {t3 - t2:.3f} s; level sizes "
          f"{[len(p) for p in pyr.points]}, neighbour columns "
          f"{[n.shape[1] for n in pyr.neighbors]}; coarse {sl} / {tl}, caps "
          f"{s_cap} / {t_cap}", flush=True)

    stages = {}
    with torch.no_grad():
        feats, stages["backbone"] = timed(lambda: apply_kpfcn_coarse(
            params["matcher"]["backbone"], pyrd, mcfg.kpfcn))
        split = split_coarse(feats, pyrd["points"][cl], sl, tl, s_cap, t_cap)
        sf, tf, sp, tp, smask, tmask = split
        before = att.FLASH_ATTENTION.launches
        tr, stages["transformer"] = timed(lambda: apply_transformer(
            params["matcher"]["transformer"], sf, tf, sp, tp, smask, tmask,
            mcfg.transformer))
        c7_calls = (att.FLASH_ATTENTION.launches - before) // 6
        conf, stages["confidence_matrix"] = timed(lambda: confidence_matrix(
            params["matcher"]["matching"], tr[0], tr[1], tr[2], tr[3], smask,
            tmask, mcfg.matching, mcfg.transformer.pe_type))
        _, stages["extract_matches_all"] = timed(lambda: extract_matches_all(
            conf, mcfg.matching.confidence_threshold))
        _, stages["soft_procrustes"] = timed(lambda: soft_procrustes(
            conf, sp, tp, smask, tmask, mcfg.procrustes))
        data, stages["matcher_inference"] = timed(lambda: lm.matcher_inference(
            params, pyrd, sl, tl, lcfg, s_cap=s_cap, t_cap=t_cap))
        _, stages["neco_filter"] = timed(lambda: lm.neco_filter(params, data,
                                                                lcfg))
        _, stages["landmark_inference"] = timed(lambda: lm.landmark_inference(
            params, pyrd, sl, tl, lcfg, s_cap=s_cap, t_cap=t_cap))
    for name, ms in stages.items():
        print(f"{name:22s} {ms:9.3f} ms", flush=True)
    print(f"C7 launches in one transformer pass: {c7_calls}", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        lm.landmark_inference(params, pyrd, sl, tl, lcfg, s_cap=s_cap,
                              t_cap=t_cap)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "torch_lndp_trace.json"))
    print(f"profiled landmark_inference: wall {wall * 1e3:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms ({100.0 * busy / 1e6 / wall:.1f}% of "
          f"the window), {launches} device kernels", flush=True)
    for dev_us, count, name in rows[:30]:
        print(f"{dev_us / 1e3:9.3f} ms {count:5d} launches  {name[:100]}")
    solve = solve_stage(params, pyrd, sl, tl, lcfg, s_cap, t_cap, src, tgt,
                        dev)
    print(f"landmark solve through C5: {solve['landmarks']} landmarks in "
          f"{solve['rows']} rows ({solve['tiles_with_landmarks']} of "
          f"{solve['tiles']} tiles of {solve['tile']} hold one), iterations "
          f"{solve['iters']}, "
          f"{solve['ms_per_iter']:.4f} ms/iter (host, median of 3: "
          f"{', '.join(f'{t:.4f}' for t in solve['ms_per_iter_runs'])}); "
          f"under the profiler C5 {solve['c5_us']:.2f} us a launch "
          f"({solve['c5_launches']} launches), device busy "
          f"{solve['busy_ms_per_iter']:.4f} ms/iter, "
          f"{solve['busy_share']:.1f}% of the window; {smi}", flush=True)
    print(json.dumps({"device": smi, "stages_ms": stages,
                      "profiled_wall_ms": wall * 1e3,
                      "device_busy_ms": busy / 1e3, "launches": launches,
                      "peak_memory_gb":
                          torch.cuda.max_memory_allocated() / 1e9,
                      "solve": solve}))


def solve_stage(params, pyrd, sl, tl, lcfg, s_cap, t_cap, src, tgt, dev):
    """The LNDP solve through C5 on this pair's landmarks: host ms/iter of
    three solves, then one under ``torch.profiler`` (C5's device time a
    launch, the device-busy time an iteration and its share of the
    window)."""
    import deformationpyramid_tpu_torch as dp
    from deformationpyramid_tpu_torch.match import landmark as lm
    from deformationpyramid_tpu_torch.ops import fused_iteration as fi
    from deformationpyramid_tpu_torch.utils.config import load_config

    top = load_config(str(REPO / "config" / "LNDP.yaml"))
    scfg = dp.SolverConfig(
        pyramid=dp.NDPConfig(m=top.m, k0=top.k0, depth=top.depth,
                             width=top.width,
                             rotation_format=top.rotation_format,
                             motion=top.motion_type),
        iters=top.iters, lr=top.lr, max_break_count=top.max_break_count,
        break_threshold_ratio=top.break_threshold_ratio, samples=top.samples,
        w_ldmk=float(top.w_ldmk), w_cd=top.w_cd, trunc_cd=top.trunc_cd,
        use_fused_iteration=True, use_fused_ldmk=True)
    with torch.no_grad():
        out = lm.landmark_inference(params, pyrd, sl, tl, lcfg, s_cap=s_cap,
                                    t_cap=t_cap)
    pad = max(2048, s_cap) - s_cap
    s_l = torch.nn.functional.pad(out["ldmk_s"], (0, 0, 0, pad))
    t_l = torch.nn.functional.pad(out["ldmk_t"], (0, 0, 0, pad))
    l_v = torch.nn.functional.pad(out["ldmk_valid"], (0, pad))
    src_d, tgt_d = (torch.from_numpy(a).to(dev) for a in (src, tgt))

    def solve():
        return dp.register_pair(400, src_d, tgt_d, scfg, src_ldmk=s_l,
                                tgt_ldmk=t_l, ldmk_valid=l_v)

    _, stats = solve()
    torch.cuda.synchronize()
    iters = int(stats["iters"].sum())
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3 / iters)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, c5_us, c5_n = 0.0, 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        busy += dev_us
        if "ldmk_iteration" in ev.key:
            c5_us += dev_us
            c5_n += ev.count
    # the C5 tiles that hold a valid landmark (the others skip their VJP)
    tile = fi.ldmk_tile(int(l_v.shape[0]), scfg.pyramid)
    pad_v = torch.nn.functional.pad(l_v, (0, -l_v.shape[0] % tile))
    full_tiles = int(pad_v.reshape(-1, tile).any(1).sum())
    return dict(rows=int(l_v.shape[0]), landmarks=int(l_v.sum()),
                tile=tile, tiles=pad_v.shape[0] // tile,
                tiles_with_landmarks=full_tiles,
                iters=stats["iters"].tolist(),
                ms_per_iter=statistics.median(runs), ms_per_iter_runs=runs,
                c5_us=c5_us / max(c5_n, 1), c5_launches=c5_n,
                busy_ms_per_iter=busy / 1e3 / iters,
                busy_share=100.0 * busy / 1e6 / wall)


if __name__ == "__main__":
    main()
