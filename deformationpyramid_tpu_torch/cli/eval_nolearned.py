"""NDP and baseline evaluation on 4DMatch-F / 4DLoMatch-F.

Counterpart of ``deformationpyramid_tpu/cli/eval_nolearned.py`` (the
reference benchmark program ``eval_nolearned.py``): reads a reference-format
yaml, solves every pair of a split and scores the scene flow of the warped
source (EPE, AccS, AccR, outlier on the full cloud and on its visible and
occluded parts).

Usage:
  python -m deformationpyramid_tpu_torch.cli.eval_nolearned \\
      --config config/NDP.yaml
  python -m deformationpyramid_tpu_torch.cli.eval_nolearned \\
      --config config/baselines/NSFP.yaml --data-root /data/split \\
      --splits 4DMatch-F --limit 64 --resume

``deformation_model`` NDP (every ``motion_type`` and ``rotation_format`` of
``config/NDP.yaml``), NSFP, Nerfies and Sinkhorn are covered; ED (N-ICP)
delegates to ``cli/eval_ed.py`` with the same config and splits, as the JAX
CLI does. The fast path (NDP, NSFP, Nerfies) subsamples and centres each
pair on the host, runs one fixed-shape solve at [samples, 3] and a warp +
metrics pass over the full cloud at a power-of-two bucket, and fetches the
12 metrics of a pair as one vector; ``--no-fast`` solves padded bucket
batches pair by pair through ``register_pair`` and its siblings
(Sinkhorn's only path: it scores the moved subset). Everything runs on
``--device`` (``cuda`` by default). What is not ported raises:
``--visualize`` (``utils/vis.py``) and the multi-host shard
(``parallel/mesh.py``).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..data.fourdmatch import BucketBatcher, FourDMatchDataset, _bucket_size
from ..metrics.flow import compute_flow_metrics
from ..models.baselines import (init_nerfies_params, init_nsfp_params,
                                nerfies_warp)
from ..models.pyramid import (NDPConfig, init_pyramid_params, params_to_numpy,
                              warp, warp_numpy)
from ..solve.baselines import (NSFPSolverConfig, NerfiesSolverConfig,
                               SinkhornSolverConfig, nerfies_net, nsfp_warp,
                               optimize_nerfies, optimize_nsfp,
                               register_nerfies, register_nsfp,
                               register_sinkhorn)
from ..solve.registration import (SolverConfig, optimize_pyramid,
                                  register_batch)
from ..utils.config import AttrDict, load_config
from ..utils.logging import AverageMeter, Logger, write_run_provenance
from ..utils.reporting import split_summary
from ..utils.timers import Timers

Tensor = torch.Tensor

FAST_MODELS = ("NDP", "NSFP", "Nerfies")
METRIC_KEYS = ("full-epe", "full-AccS", "full-AccR", "full-outlier",
               "vis-epe", "vis-AccS", "vis-AccR", "vis-outlier",
               "occ-epe", "occ-AccS", "occ-AccR", "occ-outlier")


def _fused_iter_explicit(cfg: AttrDict) -> bool | None:
    """The yaml key, else the ``DP_FUSED_ITER`` environment variable, else
    None (the unfused loop). NSFP's default: the fused iteration is opt-in,
    as in the JAX package."""
    if "use_fused_iteration" in cfg:
        return bool(cfg["use_fused_iteration"])
    env = os.environ.get("DP_FUSED_ITER")
    if env is not None:
        return bool(int(env))
    return None


def _fused_iter_default(cfg: AttrDict, device: torch.device) -> bool | None:
    """The fused-iteration kernels for the NDP sweep: yaml key >
    ``DP_FUSED_ITER`` > on when the device is CUDA. The per-configuration
    gate (``supports_fused_iteration``) still decides per solve: ``w_reg >
    0`` runs the kernels with the nonrigidity head (``nonrigidity_est``
    follows ``w_reg``), depth < 2 the unfused loop. ``DP_SWEEP_REUSE``,
    ``DP_SWEEP_REUSE_C`` and ``DP_SWEEP_REUSE_DRIFT`` reach the fused
    level loop from the environment, as in the JAX package."""
    explicit = _fused_iter_explicit(cfg)
    if explicit is not None:
        return explicit
    return device.type == "cuda" or None


def _loop_registrar(register, scfg):
    """B pairs one after another through a single-pair ``register``;
    outputs stacked along a leading axis."""
    def run(seeds, src, tgt, src_valid, tgt_valid):
        outs = [register(int(seeds[b]), src[b], tgt[b], scfg, src_valid[b],
                         tgt_valid[b]) for b in range(src.shape[0])]
        *arrays, stats = zip(*outs)
        return (*(torch.stack(a) for a in arrays),
                {k: torch.stack([s[k] for s in stats]) for k in stats[0]})
    return run


def solver_from_config(cfg: AttrDict, device: torch.device | str = "cuda"):
    """Map a reference-format yaml onto (solver config, batched runner,
    flow scope). The runner takes (seeds [B], src [B, N, 3], tgt [B, M, 3],
    src_valid, tgt_valid) and returns (warped [B, N, 3], stats), or for the
    ``"subset"`` scope (Sinkhorn) (moved samples, their validity, their
    indices into src, stats)."""
    device = torch.device(device)
    model = cfg.get("deformation_model", "NDP")
    if model == "NDP":
        scfg = SolverConfig(
            pyramid=NDPConfig(
                m=cfg.get("m", 9), k0=cfg.get("k0", -8),
                depth=cfg.get("depth", 3), width=cfg.get("width", 128),
                rotation_format=cfg.get("rotation_format", "axis_angle"),
                motion=cfg.get("motion_type", "SE3"),
                nonrigidity_est=cfg.get("w_reg", 0.0) > 0,
            ),
            iters=cfg.get("iters", 500), lr=cfg.get("lr", 0.01),
            max_break_count=cfg.get("max_break_count", 15),
            break_threshold_ratio=cfg.get("break_threshold_ratio", 0.001),
            samples=cfg.get("samples", 2000), w_reg=cfg.get("w_reg", 0.0),
            # the reference hardcodes 1e9 (model/registration.py:212); a
            # finite value is the partial-overlap control (--trunc-chamfer)
            trunc_chamfer=cfg.get("trunc_chamfer", 1e9),
            use_fused_iteration=_fused_iter_default(cfg, device),
        )

        def run(seeds, src, tgt, src_valid, tgt_valid):
            return register_batch([int(s) for s in seeds], src, tgt, scfg,
                                  src_valid, tgt_valid)
        return scfg, run, "full"
    common = dict(iters=cfg.get("iters", 5000), lr=cfg.get("lr", 0.01),
                  max_break_count=cfg.get("max_break_count", 70),
                  break_threshold_ratio=cfg.get("break_threshold_ratio",
                                                0.001),
                  samples=cfg.get("samples", 2000))
    if model == "NSFP":
        scfg = NSFPSolverConfig(
            **common, use_fused_iteration=_fused_iter_explicit(cfg))
        return scfg, _loop_registrar(register_nsfp, scfg), "full"
    if model == "Nerfies":
        # As the JAX package: the field keeps NerfiesConfig's defaults (6
        # bands, depth 7, width 128) whatever the yaml's band_width, depth
        # and width say.
        scfg = NerfiesSolverConfig(**common)
        return scfg, _loop_registrar(register_nerfies, scfg), "full"
    if model == "Sinkhorn":
        scfg = SinkhornSolverConfig(
            blur=cfg.get("blur", 0.1), reach=cfg.get("reach", 1.0),
            n_steps=cfg.get("Nsteps", 11), lr=cfg.get("lr", 1.0),
            samples=cfg.get("samples", 2000))
        return scfg, _loop_registrar(register_sinkhorn, scfg), "subset"
    raise KeyError(f"unknown deformation_model {model!r} "
                   "(ED requires the depth/graph eval path)")


def initial_params(model: str, scfg, seed: int,
                   device: torch.device | str | None = None):
    """The fast path's initial weights of one pair, from its seed."""
    gen = torch.Generator().manual_seed(int(seed))
    if model == "NDP":
        return init_pyramid_params(gen, scfg.pyramid, device=device)
    if model == "NSFP":
        return init_nsfp_params(gen, scfg.net, device=device)
    if model == "Nerfies":
        return init_nerfies_params(gen, nerfies_net(scfg), device=device)
    raise KeyError(f"no fast path for deformation_model {model!r}")


def metric_vector(flow: Tensor, flow_gt: Tensor, overlap: Tensor,
                  valid: Tensor | None = None) -> Tensor:
    """The 12 metrics in METRIC_KEYS order as one [12] tensor."""
    m = compute_flow_metrics(flow, flow_gt, overlap=overlap, valid=valid)
    return torch.stack([m[k] for k in METRIC_KEYS])


def _with_iters(vec: Tensor, stats: dict, j: int | None = None) -> Tensor:
    """The metric vector with the solver's iteration counts appended (of
    batch row ``j``), so that both come back in the one fetch of a pair."""
    iters = stats["iters"] if j is None else stats["iters"][j]
    return torch.cat([vec, iters.reshape(-1).to(vec)])


def make_fast_solver(model: str, scfg, device: torch.device | str = "cuda"):
    """The fast path's three functions.

    The per-iteration cost of a solve does not depend on the cloud's size,
    because the loss runs on the fixed ``samples`` subset (reference
    ``model/registration.py:156-159``); only the final warp sees the full
    cloud. So a sweep pays

    * ``solve_fixed(seed, st_packed, params=None)``: one solve at the
      [samples, 3] shape shared by every pair (subsample and centring
      happen on the host), from ``initial_params(model, scfg, seed)``
      unless initial ``params`` are given, returning (params, stats);
    * ``warp_metrics(state, packed, delta_mean)``: the forward-only warp of
      the full cloud at a power-of-two bucket and the 12 metrics as ONE
      [12] vector, so one small tensor a pair crosses back to the host;
    * ``warp_bucket(state, packed)``: the warped cloud alone.

    Inputs are packed: the samples as one [2, samples, 4] block (xyz +
    valid), the warp / metric input as one [N, 7] block (centred source,
    ground-truth flow, and a code: -1 padding, 0 valid, 1 valid and
    overlapping). NSFP and Nerfies share the optimize-then-apply shape
    (reference ``registration.py:470-540, 265-339``); Sinkhorn scores the
    moved subset and has no fast path.
    """
    device = torch.device(device)
    if model == "NDP":
        def opt_fn(params, ss, sv, ts, tv):
            return optimize_pyramid(params, ss, sv, ts, tv, scfg)

        def full_warp(state, src_c):
            return warp(state[0], src_c, scfg.pyramid)[0]
    elif model == "NSFP":
        def opt_fn(params, ss, sv, ts, tv):
            return optimize_nsfp(params, ss, sv, ts, tv, scfg)

        def full_warp(state, src_c):
            return nsfp_warp(state[0], src_c, scfg)
    elif model == "Nerfies":
        def opt_fn(params, ss, sv, ts, tv):
            return optimize_nerfies(params, ss, sv, ts, tv, scfg)

        def full_warp(state, src_c):
            last_it = torch.clamp_min(state[1]["iters"] - 1, 0)
            return nerfies_warp(state[0], src_c, last_it, nerfies_net(scfg))
    else:
        raise KeyError(f"no fast path for deformation_model {model!r}")

    def solve_fixed(seed: int, st_packed: Tensor, params=None):
        if params is None:
            params = initial_params(model, scfg, seed, device)
        s_sample, s_valid = st_packed[0, :, :3], st_packed[0, :, 3] > 0.5
        t_sample, t_valid = st_packed[1, :, :3], st_packed[1, :, 3] > 0.5
        return opt_fn(params, s_sample.contiguous(), s_valid,
                      t_sample.contiguous(), t_valid)

    @torch.no_grad()
    def warp_bucket(state, packed: Tensor) -> Tensor:
        return full_warp(state, packed[:, :3].contiguous())

    @torch.no_grad()
    def warp_metrics(state, packed: Tensor, delta_mean: Tensor) -> Tensor:
        src_c = packed[:, :3].contiguous()
        code = packed[:, 6]        # -1 pad, 0 valid non-overlap, 1 overlap
        warped = full_warp(state, src_c)
        flow = warped - src_c + delta_mean   # == (warped + tgt_mean) - src
        return metric_vector(flow, packed[:, 3:6], code > 0.5, code > -0.5)

    return solve_fixed, warp_metrics, warp_bucket


def _prep_sample(pts: np.ndarray, mean: np.ndarray, k: int,
                 rng: np.random.Generator) -> np.ndarray:
    """Host-side random ``k``-subset of a centred cloud -> [k, 4] packed
    block (xyz, valid flag), zero-padded.

    Mirrors the reference's ``randperm[:samples]`` subsample
    (``model/registration.py:156-159``) at a fixed output shape. The same
    numpy stream as the JAX package's CLI, so both solve the same subset.
    """
    n = len(pts)
    take = min(k, n)
    out = np.zeros((k, 4), np.float32)
    idx = rng.permutation(n)[:take]
    out[:take, :3] = pts[idx] - mean
    out[:take, 3] = 1.0
    return out


def fast_inputs(pair, pid: int, seed: int, samples: int
                ) -> tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """One pair's host-side inputs to the fast path, from its id ``pid``
    and ``--seed``: the [2, samples, 4] sample block of ``solve_fixed``, the
    [bucket, 7] block of ``warp_metrics`` (see :func:`make_fast_solver`),
    the source's row count, and the target's mean less the source's."""
    rng = np.random.default_rng([seed, pid])
    ns = len(pair.src)
    src_mean = pair.src.mean(0)
    tgt_mean = pair.tgt.mean(0)
    st_packed = np.stack([_prep_sample(pair.src, src_mean, samples, rng),
                          _prep_sample(pair.tgt, tgt_mean, samples, rng)])
    packed = np.full((_bucket_size(ns), 7), -1.0, np.float32)
    packed[:, :6] = 0.0
    packed[:ns, :3] = pair.src - src_mean
    packed[:ns, 3:6] = pair.flow_gt
    packed[:ns, 6] = pair.overlap.astype(np.float32)
    return st_packed, packed, ns, (tgt_mean - src_mean).astype(np.float32)


def pair_id(name: str) -> int:
    """A pair's stable id, the CRC of its file name: a resumed sweep (the
    entry list filtered) samples and seeds each pair as the first run did."""
    return zlib.crc32(os.path.basename(name).encode())


def pair_seed(pid: int, seed: int) -> int:
    """The solver seed of a pair: ``--seed`` folds into the pair's id."""
    return (pid + seed) & 0x7FFFFFFF


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--splits", nargs="*",
                    default=["4DMatch-F", "4DLoMatch-F"])
    ap.add_argument("--data-root", default=None,
                    help="override the yaml's data_root")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solves (default cuda)")
    ap.add_argument("--batch", type=int, default=16,
                    help="pairs a bucket batch on the --no-fast path")
    ap.add_argument("--limit", type=int, default=None,
                    help="evaluate only the first N pairs per split")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="skip pairs already recorded in the split's "
                         ".done file and recover their metrics from its "
                         ".pairs.jsonl ledger")
    ap.add_argument("--square-buckets", action="store_true", default=True,
                    help="pad src/tgt to the same bucket")
    ap.add_argument("--no-square-buckets", dest="square_buckets",
                    action="store_false")
    ap.add_argument("--stream", action="store_true",
                    help="--no-fast path: batches of one pair with a "
                         "bounded window of unfetched results")
    ap.add_argument("--depth", type=int, default=16,
                    help="pairs whose metric vector may wait unfetched")
    ap.add_argument("--visualize", action="store_true",
                    help="not ported (needs utils/vis.py): raises")
    ap.add_argument("--no-fast", dest="fast", action="store_false",
                    help="disable the fixed-shape fast path (NDP / NSFP / "
                         "Nerfies) and solve padded bucket batches")
    ap.add_argument("--log-dir", default=None,
                    help="override the snapshot directory (default "
                         "snapshot/<folder>/<exp_dir> from the config)")
    ap.add_argument("--trunc-chamfer", type=float, default=None,
                    help="override the pure-chamfer-mode truncation "
                         "(reference default 1e9, model/registration.py:212)")
    ap.add_argument("--host-metrics", action="store_true",
                    help="fetch the pyramid's parameters and run the "
                         "full-cloud warp and the metrics on the host "
                         "(numpy; NDP fast path, axis_angle only)")
    return ap


def main(argv: list[str] | None = None) -> dict[str, dict]:
    """Run the sweep. Returns, per split that had data, ``{"scores":
    {metric: mean over the pairs done, recovered ones included}, "pairs":
    pairs solved in this run, "seconds": their wall time, "iters": {pair
    name: the solver's iteration counts (per level for NDP)}}``."""
    args = build_parser().parse_args(argv)
    cfg = load_config(args.config)
    if args.trunc_chamfer is not None:
        cfg["trunc_chamfer"] = args.trunc_chamfer
    if args.data_root is not None:
        cfg["data_root"] = args.data_root
    model = cfg.get("deformation_model", "NDP")
    if model == "ED":
        # The reference drives all five deformation models through one entry
        # point; ED needs the depth / graph path, which lives in eval_ed, as
        # in the JAX package (cli/eval_nolearned.py:310-322): delegate.
        from . import eval_ed
        print("[eval_nolearned] ED config -> delegating to cli.eval_ed")
        ed_argv = ["--config", args.config, "--splits", *args.splits,
                   "--device", args.device]
        if args.limit is not None:
            ed_argv += ["--limit", str(args.limit)]
        if args.data_root is not None:
            ed_argv += ["--data-root", args.data_root]
        if args.visualize:
            ed_argv.append("--visualize")
        return eval_ed.main(ed_argv)
    if args.visualize:
        raise NotImplementedError(
            "--visualize needs utils/vis.py, which is not ported")
    if int(os.environ.get("JAX_NUM_PROCESSES", "1")) > 1 \
            or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "the multi-host shard of the pair list (parallel/mesh.py) is "
            "not ported: run one process")
    device = torch.device(args.device)
    if device.type == "cuda":
        # the kernels launch on the current device: make it the one asked for
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)

    snap_dir = args.log_dir or os.path.join(
        "snapshot", str(cfg.get("folder", "eval")),
        str(cfg.get("exp_dir", "run")))
    os.makedirs(snap_dir, exist_ok=True)
    write_run_provenance(snap_dir, args.config, device=str(device))

    scfg, run_batch, flow_scope = solver_from_config(cfg, device)
    timers = Timers()
    use_fast = args.fast and model in FAST_MODELS
    host_metrics = False
    if use_fast:
        solve_fixed, warp_metrics, _ = make_fast_solver(model, scfg, device)
        host_metrics = args.host_metrics and model == "NDP"
        if args.host_metrics and not host_metrics:
            print("[warn] --host-metrics is NDP-only; using device metrics")

    report: dict[str, dict] = {}
    for split in args.splits:
        ds = FourDMatchDataset(cfg.data_root, split)
        if len(ds) == 0:
            print(f"[skip] no data for split {split} under {cfg.data_root}")
            continue
        if args.limit is not None:
            ds.entries = ds.entries[: args.limit]
        n_total = len(ds)  # before resume filtering, for an honest done/total
        logger = Logger(os.path.join(snap_dir, split + ".log"))
        meters: dict[str, AverageMeter] = {}
        n_done = 0

        # Resume: the .pairs.jsonl ledger records every finished pair's
        # metrics, so a resumed sweep both skips finished pairs and
        # recovers their share of the final means.
        done_path = os.path.join(snap_dir, split + ".done")
        ledger_path = os.path.join(snap_dir, split + ".pairs.jsonl")
        if args.resume and os.path.exists(done_path):
            with open(done_path) as f:
                finished = set(f.read().split())
            before = len(ds.entries)
            ds.entries = [e for e in ds.entries if e not in finished]
            print(f"[resume] {before - len(ds.entries)} pairs already done")
            if os.path.exists(ledger_path):
                recovered = set()
                with open(ledger_path) as f:
                    for line in f:
                        row = json.loads(line)
                        name = row.pop("name", None)
                        if name in finished and name not in recovered:
                            recovered.add(name)
                            for k2, v in row.items():
                                meters.setdefault(k2, AverageMeter()).update(v)
                n_done = len(recovered)
        n_recovered = n_done   # counted in the means, not in this run's rate
        done_fw = open(done_path, "a")
        ledger_fw = open(ledger_path, "a")
        stamps: list[float] = []   # harvest times -> the per-pair summary
        iters_done: dict[str, list[int]] = {}

        def record(name: str, vals) -> None:
            """Fold one pair's fetched vector (the 12 metrics, then the
            solver's iteration counts) into the meters and the ledger."""
            nonlocal n_done
            iters_done[name] = [int(v) for v in vals[len(METRIC_KEYS):]]
            row = dict(zip(METRIC_KEYS, (float(v) for v in vals)))
            for k2, v in row.items():
                meters.setdefault(k2, AverageMeter()).update(v)
            n_done += 1
            ledger_fw.write(json.dumps(dict(row, name=name)) + "\n")
            ledger_fw.flush()
            done_fw.write(name + "\n")
            done_fw.flush()

        def dispatch(batch):
            """Solve one bucket batch; the per-pair metric vectors stay on
            the device. The batcher fills a bucket's last batch by repeating
            its final pair (a compiled batch wants a fixed shape); pairs
            are solved one after another here, so the repeats are dropped
            before the solve."""
            rows = [j for j, i in enumerate(batch.indices)
                    if i not in batch.indices[:j]]
            names = [batch.names[j] for j in rows]

            def dev(a):
                return torch.from_numpy(a[rows]).to(device)

            seeds = [pair_seed(pair_id(n), args.seed) for n in names]
            src, valid = dev(batch.src), dev(batch.src_valid)
            out = run_batch(seeds, src, dev(batch.tgt), valid,
                            dev(batch.tgt_valid))
            flow_gt, overlap = dev(batch.flow_gt), dev(batch.overlap)
            vecs = []
            for j, name in enumerate(names):
                if flow_scope == "subset":
                    # Sinkhorn is scored on the moved sample subset
                    # (reference eval_nolearned.py:105-108)
                    moved, s_valid, s_idx, _ = out
                    sel = s_idx[j][s_valid[j]]
                    vec = metric_vector(moved[j][s_valid[j]] - src[j][sel],
                                        flow_gt[j][sel], overlap[j][sel])
                else:
                    vec = metric_vector(out[0][j] - src[j], flow_gt[j],
                                        overlap[j], valid[j])
                vecs.append((name, _with_iters(vec, out[-1], j)))
            return vecs

        def harvest(vecs) -> None:
            """Fetch one dispatched batch's metric vectors (one transfer)
            and fold its pairs into the meters. One wait covered the whole
            batch, so the stamps are amortised: k equal intervals."""
            vals = torch.stack([v for _, v in vecs]).cpu().numpy()
            for (name, _), row in zip(vecs, vals):
                record(name, row)
            now = time.perf_counter()
            prev, k = stamps[-1], len(vecs)
            stamps.extend(prev + (now - prev) * (j + 1) / k for j in range(k))

        def harvest_fast(item) -> None:
            """Fetch one solved pair (its vector, or with --host-metrics
            its solver state) and fold it into the meters."""
            name, out, host_data = item
            if host_data is not None:
                # --host-metrics: fetch the parameters, warp the true rows
                # and score on the host; padded rows keep zero flow
                packed, delta, ns_h = host_data
                params, stats = out
                warped = warp_numpy(params_to_numpy(params),
                                    packed[:ns_h, :3], scfg.pyramid)
                flow = np.zeros((len(packed), 3), np.float32)
                flow[:ns_h] = warped - packed[:ns_h, :3] + delta
                code = torch.from_numpy(packed[:, 6])
                vals = _with_iters(
                    metric_vector(torch.from_numpy(flow),
                                  torch.from_numpy(packed[:, 3:6]),
                                  code > 0.5, code > -0.5),
                    {"iters": stats["iters"].cpu()}).numpy()
            else:
                vals = out.cpu().numpy()   # the one fetch of this pair
            record(name, vals)
            stamps.append(time.perf_counter())

        t_split = time.perf_counter()
        stamps.append(t_split)
        try:
            if use_fast:
                # The npz read, the numpy packing and the host-to-device copies
                # run a few pairs ahead in worker threads; solved pairs wait in
                # a bounded window until their metric vector is fetched.
                def prep(i):
                    pair = ds[i]
                    pid = pair_id(pair.name)
                    st_packed, packed, ns, delta = fast_inputs(
                        pair, pid, args.seed, scfg.samples)
                    st_dev = torch.from_numpy(st_packed).to(device)
                    if host_metrics:   # the big block never goes to the device
                        return pair.name, pid, st_dev, packed, ns, delta
                    return (pair.name, pid, st_dev,
                            torch.from_numpy(packed).to(device), ns,
                            torch.from_numpy(delta).to(device))

                look_ahead = max(2, min(args.depth // 2, 8))
                n_entries = len(ds.entries)
                pending: list = []
                with ThreadPoolExecutor(2) as pool:
                    futs = [pool.submit(prep, i)
                            for i in range(min(look_ahead, n_entries))]
                    for i in range(n_entries):
                        timers.tic("dispatch")
                        name, pid, st_packed, packed, ns, delta = \
                            futs.pop(0).result()
                        if i + look_ahead < n_entries:
                            futs.append(pool.submit(prep, i + look_ahead))
                        state = solve_fixed(pair_seed(pid, args.seed),
                                            st_packed)
                        if host_metrics:
                            pending.append((name, state, (packed, delta, ns)))
                        else:
                            pending.append((name, _with_iters(
                                warp_metrics(state, packed, delta), state[1]),
                                None))
                        timers.toc("dispatch")
                        if len(pending) > args.depth:
                            with timers.span("harvest"):
                                harvest_fast(pending.pop(0))
                    while pending:
                        with timers.span("harvest"):
                            harvest_fast(pending.pop(0))
            elif args.stream:
                pending = []
                for batch in BucketBatcher(ds, 1, square=args.square_buckets):
                    with timers.span("dispatch"):
                        pending.append(dispatch(batch))
                    if len(pending) > args.depth:
                        with timers.span("harvest"):
                            harvest(pending.pop(0))
                while pending:
                    with timers.span("harvest"):
                        harvest(pending.pop(0))
            else:
                for batch in BucketBatcher(ds, args.batch,
                                           square=args.square_buckets):
                    with timers.span("registration", sync=True):
                        vecs = dispatch(batch)
                    harvest(vecs)
        finally:
            done_fw.close()
            ledger_fw.close()
        dt = time.perf_counter() - t_split
        n_this_run = n_done - n_recovered   # recovered pairs took no time
        if n_this_run:
            print(f"[{split}] {n_this_run} pairs in {dt:.1f}s "
                  f"= {n_this_run / dt:.2f} pairs/s")
            summary = split_summary("ndp_suite", split, stamps, n_this_run,
                                    dt)
            print(summary)
            logger.write(summary + "\n")

        msg = f"{n_done}/{n_total}: " + "\t".join(
            f"{k}: {v.avg:.3f}" for k, v in meters.items())
        logger.write(msg + "\n")
        logger.close()
        print("score on", split, "\n", msg)
        report[split] = {"scores": {k: v.avg for k, v in meters.items()},
                         "pairs": n_this_run, "seconds": dt,
                         "iters": iters_done}

    print("time cost average")
    for line in timers.get_strings():
        print(line)
    return report


if __name__ == "__main__":
    main()
