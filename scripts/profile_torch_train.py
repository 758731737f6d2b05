"""Where the time of one matcher training step goes, on a CUDA GPU.

    python scripts/profile_torch_train.py [--out DIR] [--points N]

Builds the full-width landmark model of ``config/LNDP.yaml`` (weights from
seed 0), fabricates one 4DMatch-format pair of ~N points with
``write_4dmatch_suite`` and collates it through ``cli/train_matcher.py``'s
batch stream. For each attention route ('flash': kernels C7-C9; 'xla': the
einsum route) it times, each ending in a synchronise, median of 5: the
forward under ``no_grad``, forward + backward (``value_and_grad``), the
optimizer's update alone, and the whole step, with the peak memory of the
step. Then one flash-route step under ``torch.profiler``: device time per
kernel name and by group (C7 / C8 / C9, GEMMs, gather and scatter kernels,
softmax, the rest), the device-busy share of the window, and the Chrome
trace in ``--out``. Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]

GROUPS = (("C7 flash_attention_fwd", ("flash_attention_kernel",
                                     "flash_attention_merge")),
          ("C8 flash_attention_bwd_dkv", ("flash_attention_bwd_dkv",)),
          ("C9 flash_attention_bwd_dq", ("flash_attention_bwd_dq",)),
          ("GEMM", ("gemm", "cutlass", "cublas", "xmma")),
          ("gather / scatter / index", ("index", "gather", "scatter")),
          ("softmax", ("softmax",)))


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
    ap.add_argument("--points", type=int, default=6000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    sys.path.insert(0, str(REPO))
    from deformationpyramid_tpu_torch.cli.train_matcher import \
        make_matcher_batch_stream
    from deformationpyramid_tpu_torch.data.collate import \
        calibrate_neighborhood_limits
    from deformationpyramid_tpu_torch.data.fourdmatch import FourDMatchDataset
    from deformationpyramid_tpu_torch.data.synthetic import \
        write_4dmatch_suite
    from deformationpyramid_tpu_torch.match import attention as att
    from deformationpyramid_tpu_torch.match import landmark as lm
    from deformationpyramid_tpu_torch.match.backbone import KPFCN_ARCHITECTURE
    from deformationpyramid_tpu_torch.match.config_loader import \
        landmark_config_from_yaml
    from deformationpyramid_tpu_torch.match.losses import match_motion_loss
    from deformationpyramid_tpu_torch.match.pipeline import apply_matcher
    from deformationpyramid_tpu_torch.train import trainer

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    base = landmark_config_from_yaml(
        str(REPO / "config" / "configs" / "correspondence.yaml"))
    cfgs = {impl: dataclasses.replace(base, matcher=dataclasses.replace(
        base.matcher, transformer=dataclasses.replace(
            base.matcher.transformer, attention_impl=impl)))
        for impl in ("flash", "xla")}
    params = lm.init_landmark_model(torch.Generator().manual_seed(0),
                                    cfgs["flash"], device=dev)["matcher"]
    with tempfile.TemporaryDirectory() as root:
        write_4dmatch_suite(root, "train", n_pairs=1,
                            size_clusters=(args.points,), seed=7)
        ds = FourDMatchDataset(root, "train", augment=False)
        limits = calibrate_neighborhood_limits(
            [(ds[0].src, ds[0].tgt)], base.matcher.kpfcn, KPFCN_ARCHITECTURE)
        b = next(iter(make_matcher_batch_stream(ds, base, limits,
                                                device=dev)()))
    args_ = (b["pyramid"], b["src_len_c"], b["tgt_len_c"], b["match_gt"],
             b["match_gt_valid"], b["coarse_flow"], b["gt_rot"], b["gt_trn"])
    caps = dict(s_cap=b["s_cap"], t_cap=b["t_cap"])
    print(f"coarse {int(b['src_len_c'])} / {int(b['tgt_len_c'])}, caps "
          f"{caps}, {int(b['match_gt_valid'].sum())} GT matches", flush=True)
    tcfg = trainer.TrainConfig(optimizer="Adam", lr=1e-4, max_epoch=1)
    opt = trainer.make_optimizer(tcfg, 1)
    state = opt.init(params)
    result = {"device": smi}
    steps = {}
    for impl, cfg in cfgs.items():
        def loss_fn(mp, cfg=cfg):
            data = apply_matcher(mp, *args_[:3], cfg.matcher, **caps)
            return match_motion_loss(data, *args_[3:])

        stages = {}
        with torch.no_grad():
            _, stages["forward"] = timed(lambda: loss_fn(params))
        (_, grads), stages["forward_backward"] = timed(
            lambda: trainer.value_and_grad(loss_fn, params))
        _, stages["optimizer_update"] = timed(
            lambda: opt.update(grads, state, params))
        del grads
        steps[impl] = trainer.make_matcher_train_step(cfg, opt, **caps)
        torch.cuda.reset_peak_memory_stats()
        _, stages["step"] = timed(
            lambda: steps[impl](params, state, *args_))
        stages["step_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        result[impl] = stages
        print(impl, {k: round(v, 3) for k, v in stages.items()}, flush=True)

    kernels = (att.FLASH_ATTENTION, att.FLASH_ATTENTION_BWD_DKV,
               att.FLASH_ATTENTION_BWD_DQ)
    for k in kernels:
        k.launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps["flash"](params, state, *args_)
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
    groups = {name: [0.0, 0] for name, _ in GROUPS}
    groups["the rest"] = [0.0, 0]
    for dev_us, count, key in rows:
        low = key.lower()
        name = next((n for n, words in GROUPS
                     if any(w in low for w in words)), "the rest")
        groups[name][0] += dev_us / 1e3
        groups[name][1] += count
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "torch_train_trace.json"))
    print(f"profiled flash-route step: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({100.0 * busy / 1e6 / wall:.1f}% of the "
          f"window), {launches} device kernels; C7 / C8 / C9 launches "
          f"{[k.launches for k in kernels]}", flush=True)
    for name, (ms, count) in groups.items():
        print(f"{ms:9.3f} ms {count:5d} launches  {name}")
    for dev_us, count, name in rows[:25]:
        print(f"{dev_us / 1e3:9.3f} ms {count:5d} launches  {name[:100]}")
    result.update(profiled_wall_ms=wall * 1e3, device_busy_ms=busy / 1e3,
                  launches=launches,
                  groups_ms={k: v[0] for k, v in groups.items()})
    print(json.dumps(result))


if __name__ == "__main__":
    main()
