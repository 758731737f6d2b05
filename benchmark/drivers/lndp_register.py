"""LNDP registration, one pair at a time, as the learned evaluation runs it.

Per pair: the collate (``data/collate.build_pair_pyramid`` on the native
library) on a pool of ``num_workers`` host threads, then on the main
thread ``landmark_inference`` (the Lepard matcher and NeCo) and
``register_pair`` with its landmarks (kernel C5), dispatched in order and
harvested ``depth`` pairs behind, as ``cli/eval_supervised.run_eval``
does (its scoring left out). The pairs are a pool of ``per_cluster``
pairs of each 4DMatch-F size cluster; the pool, the landmark model's
weights and each pair's start come from the traffic's ``data_seed``, so
that every seed does the same work (the untrained NeCo's landmark count,
and with it the solve's iterations, follows the geometry), and
``--seed`` draws the order the pool is cycled in. The collates of the
first ``num_workers`` pairs start in set-up, so the window opens on a
full pipeline; later pairs are handed to collate as the main thread takes
one, a closed loop.

``pairs_per_s``: pairs dispatched in the window over the window, which
ends once the last of them is harvested (their solves run inside it).
``pair_latency_p90_s``: over every such pair, from the moment its raw
clouds were handed to collate (the window's start for the primed ones)
until its warped cloud is on the host.

What decides ``correct``, on the first pair of each size cluster that the
window harvests (the largest among them), stage by stage:

* collate: the reference's numpy + cKDTree collate of the same clouds
  against the program's (every level's points; every neighbour, pool and
  upsample index);
* matcher: the reference (einsum attention) on the program's collate
  against the program's confidence matrix, and its mutual-max matches (a
  row whose two candidates lie within 1e-4 may go either way);
* NeCo: the reference's confidences of the program's matches, and the
  landmarks they keep (within 1e-4 of the threshold either way);
* solve: every level of the landmark solve is followed from the
  program's own state (the level's parameters and landmark rows as the
  program handed them to it), for the program's iteration count (the
  early stop is a decision that rounding can flip): its last loss, over
  its first, and its parameters' change, by the worst leaf, the largest
  over the levels and the checked pairs. A level whose float32 reference
  parts from the same level followed in float64 by more than ``WITNESS``
  (Adam moves values whose gradient cancels to round-off by the whole
  rate, either way) is decided by round-off, not by the program: it is
  left out by that rule on the reference, and named in the diagnostics;
* answer: the reference's warp of the full source cloud through the
  program's final pyramid against the program's warped cloud.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import math
import statistics
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark import core, ranges, roofline
from benchmark.reference import collate as ref_collate
from benchmark.reference import ndp as ref_ndp
from benchmark.reference import precision
from benchmark.reference.attrdict import AttrDict as RefAttrDict
from benchmark.reference.match import config_loader as ref_loader
from benchmark.reference.match import landmark as ref_landmark
from benchmark.reference.match.backbone import KPFCN_ARCHITECTURE
from benchmark.traffic.synthetic import stratified_pool
from benchmark.weights import landmark_weights

LIMITS = {"collate_points": 0.0, "collate_index": 0.0, "conf": 1e-4,
          "match_flips": 0.0, "neco": 2e-5, "landmark_flips": 0.0,
          "solve_loss": 5e-5, "solve_change": 2.5e-3, "answer": 3e-5}
# A level is compared where its float32 reference stays within this of the
# float64 one (the change's gap of norms by the worst leaf; PERF.md).
WITNESS = 1e-3
COARSE_CAP_MIN = 512
SOLVER_BUCKET_MIN = 1024
TIE = 1e-4


def attention_bound_s(cfg: dict, src_len: int, tgt_len: int, cap: int,
                      backward: bool) -> float:
    """The least time of the matcher transformer's attention over one
    pair's valid coarse rows (``roofline.transformer_attention_bound_s``)
    at the configuration's heads and widths."""
    t = cfg["matcher"]["coarse_transformer"]
    h = int(t["n_head"])
    return roofline.transformer_attention_bound_s(
        t["layer_types"], int(src_len), int(tgt_len), int(cap), h,
        int(t["feature_dim"]) // h, backward)


def pow2_cap(n: int, minimum: int) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def _pad_rows(a: np.ndarray, rows: int, dtype) -> np.ndarray:
    out = np.zeros((rows,) + a.shape[1:], dtype)
    out[: len(a)] = a
    return out


def ref_landmark_config(cfg: dict):
    lc = ref_landmark.LandmarkConfig(
        matcher=ref_loader.matcher_config_from_yaml(
            RefAttrDict(cfg["matcher"]), cfg["max_matches"] or None),
        neco=ref_loader.neco_config_from_yaml(RefAttrDict(cfg["neco"])),
        inlier_thr=cfg["inlier_thr"],
        reject_outliers=cfg["reject_outliers"])
    return lc


def program_landmark_config(cfg: dict):
    from deformationpyramid_tpu_torch.match import config_loader
    from deformationpyramid_tpu_torch.match.landmark import LandmarkConfig
    from deformationpyramid_tpu_torch.utils.config import AttrDict

    lc = LandmarkConfig(
        matcher=config_loader.matcher_config_from_yaml(
            AttrDict(cfg["matcher"]), cfg["max_matches"] or None),
        neco=config_loader.neco_config_from_yaml(AttrDict(cfg["neco"])),
        inlier_thr=cfg["inlier_thr"],
        reject_outliers=cfg["reject_outliers"])
    m = lc.matcher
    return dataclasses.replace(lc, matcher=dataclasses.replace(
        m, transformer=dataclasses.replace(
            m.transformer, attention_impl=cfg["attention_impl"])))


def program_solver_config(cfg: dict, device: torch.device):
    from deformationpyramid_tpu_torch.models.pyramid import NDPConfig
    from deformationpyramid_tpu_torch.solve.registration import SolverConfig

    fused = device.type == "cuda"
    return SolverConfig(
        pyramid=NDPConfig(m=cfg["m"], k0=cfg["k0"], depth=cfg["depth"],
                          width=cfg["width"],
                          rotation_format=cfg["rotation_format"],
                          motion=cfg["motion_type"],
                          mlp_scale=cfg["mlp_scale"]),
        iters=cfg["iters"], lr=cfg["lr"],
        max_break_count=cfg["max_break_count"],
        break_threshold_ratio=cfg["break_threshold_ratio"],
        samples=cfg["samples"], w_ldmk=cfg["w_ldmk"], w_cd=cfg["w_cd"],
        trunc_cd=cfg["trunc_cd"], loss_eps=cfg["loss_eps"],
        use_fused_iteration=fused, use_fused_ldmk=fused)


@dataclasses.dataclass
class Item:
    """One pair of the window; what the check reads is kept for the
    ``kept`` pairs only."""

    index: int                  # position in the pool
    t_submit: float             # handed to collate
    future: object = None       # its collate
    pyr: object = None          # the program's collated pyramid
    kept: bool = False
    out: dict | None = None     # landmark_inference's output
    inputs: tuple | None = None  # the solve's padded clouds and masks
    levels: list | None = None  # each level's input and output
    warped: torch.Tensor | None = None
    stats: dict | None = None
    n_ldmk: object = 0
    iters: object = None
    shape_key: tuple = ()
    t_done: float = 0.0


class Driver:
    def __init__(self, run: core.Run, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, control: str | None = None):
        self.run, self.cfg, self.traffic = run, cfg, traffic
        self.seed, self.device, self.control = seed, device, control
        self.attempted = 0
        self.failed = 0

    # -- set-up --------------------------------------------------------------

    def setup(self) -> None:
        from deformationpyramid_tpu_torch.data import collate
        from deformationpyramid_tpu_torch.match import landmark
        from deformationpyramid_tpu_torch.match.backbone import \
            KPFCN_ARCHITECTURE as ARCH
        from deformationpyramid_tpu_torch.solve.registration import \
            register_pair

        self.collate, self.landmark = collate, landmark
        self.register_pair, self.arch = register_pair, ARCH
        t, cfg = self.traffic, self.cfg
        self.lcfg = program_landmark_config(cfg)
        self.ref_lcfg = ref_landmark_config(cfg)
        self.scfg = program_solver_config(cfg, self.device)
        # the pairs, the weights and each pair's start from the traffic's
        # data seed: every seed does the same work; ``--seed`` draws the
        # order the pool is cycled in
        data_seed = int(t["data_seed"])
        self.params = landmark_weights(self.ref_lcfg, data_seed, self.device)
        self.pool = stratified_pool(tuple(t["clusters"]),
                                    int(t["per_cluster"]), data_seed,
                                    partial=t["partial"],
                                    deform=t["deform"])
        rng = np.random.default_rng(data_seed + 1)
        self.solve_seeds = rng.integers(0, 1 << 62, size=len(self.pool))
        self.order = np.random.default_rng(self.seed).permutation(
            len(self.pool)).tolist()
        self.init = [self._initial(i) for i in range(len(self.pool))]
        # the neighbourhood limits from the first pairs, as the evaluation
        # calibrates them
        sample = [(p.src, p.tgt) for p in self.pool[: int(t["calibrate"])]]
        self.limits = collate.calibrate_neighborhood_limits(
            sample, self.lcfg.matcher.kpfcn, ARCH)
        self.attention_bound = 0.0
        if self.run.trace_requested:
            ranges.wrap_attention(self.run)
        self._record_levels()
        # every shape once: one pair of each size cluster through the chain
        seen = set()
        for i, pair in enumerate(self.pool):
            if pair.cluster in seen:
                continue
            seen.add(pair.cluster)
            item = Item(i, 0.0, pyr=self._collate(pair))
            self._dispatch(item)
            self._harvest(item)
        self.workers = ThreadPoolExecutor(int(cfg["num_workers"]))
        self.queue = itertools.cycle(self.order)
        self.ahead: collections.deque[Item] = collections.deque()
        for _ in range(int(cfg["num_workers"])):
            self._submit(0.0)
        for item in self.ahead:
            item.future.result()

    def _initial(self, i: int) -> dict:
        gen = torch.Generator().manual_seed(int(self.solve_seeds[i]))
        return {k: {kk: vv.to(self.device) for kk, vv in v.items()}
                for k, v in ref_ndp.init_params(gen, self.cfg).items()}

    def _collate(self, pair):
        return self.collate.build_pair_pyramid(
            pair.src, pair.tgt, self.lcfg.matcher.kpfcn, self.arch,
            self.limits, pad_to="pow2")

    def _submit(self, t_submit: float) -> None:
        i = next(self.queue)
        item = Item(i, t_submit)
        pair = self.pool[i]
        run = self.run

        def work():
            with run.span("collate"):
                return self._collate(pair)

        item.future = self.workers.submit(work)
        self.ahead.append(item)

    def _record_levels(self) -> None:
        """Keep a copy of the input and output of every level of a kept
        pair's solve (``register_pair``'s ``_solve_level``: the port has no
        public hook for it yet), so that the reference can follow each
        level from the program's own state. Other pairs copy nothing."""
        from deformationpyramid_tpu_torch.solve import registration

        inner = registration._solve_level
        self.recording = None

        def solve_level(lvl_params, lvl, pts, *args, **kw):
            out = inner(lvl_params, lvl, pts, *args, **kw)
            if self.recording is not None:
                p_out, x_out, stats = out
                self.recording.append(
                    (lvl, _copy(lvl_params), pts.clone(),
                     (_copy(p_out), x_out.clone(), _copy(stats))))
            return out

        registration._solve_level = solve_level

    # -- one pair ------------------------------------------------------------

    def _dispatch(self, item: Item) -> None:
        pair, pyr, dev = self.pool[item.index], item.pyr, self.device
        cl = self.lcfg.matcher.coarse_level
        sl, tl = int(pyr.src_lengths[cl]), int(pyr.tgt_lengths[cl])
        cap = pow2_cap(max(sl, tl), COARSE_CAP_MIN)
        run = self.run
        if run.tracing:
            self.attention_bound += attention_bound_s(self.cfg, sl, tl, cap,
                                                      backward=False)
        with run.span("to_device"):
            pyrd = self.collate.pyramid_to_device(pyr, dev)
        with run.span("landmark"):
            data = self.landmark.landmark_inference(
                self.params, pyrd, sl, tl, self.lcfg, s_cap=cap, t_cap=cap)
        ns, nt = len(pair.src), len(pair.tgt)
        nb = pow2_cap(ns, SOLVER_BUCKET_MIN)
        mb = pow2_cap(nt, SOLVER_BUCKET_MIN)

        def put(a):
            return torch.from_numpy(a).to(dev)

        src = put(_pad_rows(pair.src, nb, np.float32))
        tgt = put(_pad_rows(pair.tgt, mb, np.float32))
        sv = put(_pad_rows(np.ones(ns, bool), nb, bool))
        tv = put(_pad_rows(np.ones(nt, bool), mb, bool))
        self.recording = [] if item.kept else None
        with run.span("solve"):
            warped, stats = self.register_pair(
                int(self.solve_seeds[item.index]), src, tgt, self.scfg,
                src_valid=sv, tgt_valid=tv, src_ldmk=data["ldmk_s"],
                tgt_ldmk=data["ldmk_t"], ldmk_valid=data["ldmk_valid"],
                params=self.init[item.index])
        item.levels, self.recording = self.recording, None
        item.shape_key = (tuple(p.shape[0] for p in pyr.points),
                          tuple(n.shape[1] for n in pyr.neighbors), cap)
        item.out = data if item.kept else None
        item.warped, item.stats = warped, stats
        item.inputs = (src, tgt, sv, tv) if item.kept else None
        item.n_ldmk = data["ldmk_valid"].sum()

    def _harvest(self, item: Item) -> None:
        with self.run.span("harvest"):
            item.warped[: len(self.pool[item.index].src)].cpu()
            item.t_done = time.perf_counter()
            item.iters = item.stats["iters"].cpu().numpy().astype(int)
            item.n_ldmk = int(item.n_ldmk)
        if not item.kept:
            item.warped = item.stats = item.pyr = None

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float) -> None:
        run = self.run
        depth = int(self.traffic["depth"])
        t0 = time.perf_counter()
        for item in self.ahead:
            item.t_submit = t0
        deadline = t0 + seconds
        pending: collections.deque[Item] = collections.deque()
        self.done: list[Item] = []
        clusters_kept = set()
        trace_pairs = int(self.traffic.get("trace_pairs", 4))
        traced = 0
        while time.perf_counter() < deadline:
            item = self.ahead.popleft()
            with run.span("collate_wait"):
                item.pyr = item.future.result()
            self._submit(time.perf_counter())
            cluster = self.pool[item.index].cluster
            if cluster not in clusters_kept:
                clusters_kept.add(cluster)
                item.kept = True
            if self.done and run.trace_requested and traced == 0:
                run.start_trace()
            self._dispatch(item)
            self.attempted += 1
            pending.append(item)
            if run.tracing:
                traced += 1
            if len(pending) > depth:
                self._harvest(pending[0])
                self.done.append(pending.popleft())
            if run.tracing and traced >= trace_pairs:
                run.stop_trace()
        while pending:
            self._harvest(pending[0])
            self.done.append(pending.popleft())
        run.stop_trace()
        self.window_s = time.perf_counter() - t0
        run.window_s = self.window_s
        # collates still running belong to no dispatched pair
        self.workers.shutdown(wait=True, cancel_futures=True)
        self.ahead.clear()
        lat = [it.t_done - it.t_submit for it in self.done]
        self.latency_p90 = (statistics.quantiles(lat, n=10)[8]
                            if len(lat) >= 2 else math.nan)
        iters = [int(it.iters.sum()) for it in self.done]
        run.counters["iters_finished"] = float(sum(iters))
        run.counters["pairs_finished"] = float(len(self.done))
        spans = run.spans
        run.counters["collate_s"] = sum(spans.get("collate", []))
        run.counters["collates"] = float(len(spans.get("collate", [])))

    def after_window(self) -> None:
        """The traced run's counters that need the card once the window
        and its memory reading are over."""
        run = self.run
        if run.trace is not None:
            run.counters["attention_bound_s"] = self.attention_bound
        if run.trace_requested:
            run.counters["register_flops"] = self._flops()

    def end_to_end(self) -> dict:
        return {"pairs_per_s": len(self.done) / self.window_s,
                "pair_latency_p90_s": self.latency_p90}

    def diagnostics(self) -> dict:
        sizes = collections.Counter(self.pool[it.index].cluster
                                    for it in self.done)
        return {"window_s": self.window_s, "pairs": len(self.done),
                "by_cluster": dict(sizes),
                "landmarks": [it.n_ldmk for it in self.done[:12]],
                "iters": [int(it.iters.sum()) for it in self.done[:12]],
                "latency_p50": (statistics.median(
                    it.t_done - it.t_submit for it in self.done)
                    if self.done else None),
                "span_ms": {k: 1e3 * float(np.mean(v))
                            for k, v in self.run.spans.items()},
                "per_pair": getattr(self, "per_pair", None)}

    def _flops(self) -> float:
        """FLOPs the window's pairs need: the landmark model's products
        counted by ``FlopCounterMode`` over the reference at each pair's
        shapes (once a shape), and each solve's MLP forward and backward
        over its valid landmark rows."""
        from torch.utils.flop_counter import FlopCounterMode

        by_shape: dict = {}
        total = 0.0
        heads = roofline.level_heads(3, self.cfg["motion_type"], False)
        for it in self.done:
            pair = self.pool[it.index]
            key = it.shape_key
            if key not in by_shape:
                pyr = ref_collate.build_pair_pyramid(
                    pair.src, pair.tgt, self.ref_lcfg.matcher.kpfcn,
                    KPFCN_ARCHITECTURE, self.ref_limits, pad_to="pow2")
                counter = FlopCounterMode(display=False)
                with counter, precision.mode("f32"):
                    self._ref_landmarks(self._to_device(pyr))
                by_shape[key] = float(counter.get_total_flops())
            total += by_shape[key]
            total += int(it.iters.sum()) * roofline.ldmk_iteration_flops(
                it.n_ldmk, self.cfg["width"], self.cfg["depth"], heads)
        return total

    # -- the check -----------------------------------------------------------

    @functools.cached_property
    def ref_limits(self) -> list[int]:
        """The reference's neighbourhood limits, from the same pairs."""
        return ref_collate.calibrate_neighborhood_limits(
            [(p.src, p.tgt) for p in self.pool[:int(
                self.traffic["calibrate"])]],
            self.ref_lcfg.matcher.kpfcn, KPFCN_ARCHITECTURE)

    def _ref_landmarks(self, pyrd: dict) -> dict:
        """The reference landmark model on a device pyramid (``_to_device``)."""
        src_lengths, tgt_lengths = pyrd["_lengths"]
        cl = self.ref_lcfg.matcher.coarse_level
        sl, tl = int(src_lengths[cl]), int(tgt_lengths[cl])
        cap = pow2_cap(max(sl, tl), COARSE_CAP_MIN)
        with torch.no_grad():
            return ref_landmark.matcher_inference(
                self.params, pyrd, sl, tl, self.ref_lcfg, s_cap=cap,
                t_cap=cap)

    def check(self) -> list[core.Check]:
        kept = [it for it in self.done if it.kept]
        self.per_pair = []
        if not kept:
            return [core.Check("answer", math.inf, LIMITS["answer"])]
        rows = [self._check_pair(it, self.pool[it.index], self.control)
                for it in kept]
        self.failed = sum(
            any(not (math.isfinite(r[k]) and r[k] <= LIMITS[k])
                for k in LIMITS) for r in rows)
        checks = []
        for k in LIMITS:
            vals = [r[k] if math.isfinite(r[k]) else math.inf for r in rows]
            checks.append(core.Check(k, max(vals), LIMITS[k]))
        return checks

    def _check_pair(self, it: Item, pair, ctrl: str | None) -> dict:
        out = {}
        cfg = self.cfg
        # collate: the reference's of the same clouds
        pyr_r = ref_collate.build_pair_pyramid(
            pair.src, pair.tgt, self.ref_lcfg.matcher.kpfcn,
            KPFCN_ARCHITECTURE, self.ref_limits, pad_to="pow2")
        pyr_p = it.pyr
        gap, rows = 0.0, 0
        for a, b in zip(pyr_p.points, pyr_r.points):
            if a.shape != b.shape:
                return dict.fromkeys(LIMITS, math.inf)
            gap = max(gap, float(np.abs(a - b).max(initial=0.0)))
        n_lv = len(pyr_r.points)
        tables = [("neighbors", l, l, l) for l in range(n_lv)] \
            + [("pools", l, l + 1, l) for l in range(n_lv - 1)] \
            + [("upsamples", l, l, l + 1) for l in range(n_lv - 1)]
        for key, l, q, sup in tables:
            a, b = getattr(pyr_p, key)[l], getattr(pyr_r, key)[l]
            if a.shape != b.shape:
                return dict.fromkeys(LIMITS, math.inf)
            rows += _set_flips(a, b, pyr_r.points[q], pyr_r.points[sup])
        if self.ref_limits != list(self.limits):
            rows += 1
        out["collate_points"] = gap
        out["collate_index"] = float(rows)

        # matcher: the reference on the program's collate
        pyrd = self._to_device(pyr_p)
        with precision.mode("f32"):
            ref = self._ref_landmarks(pyrd)
        prog = it.out
        if ctrl:
            with _tf32(ctrl):
                prog = dict(self._ref_landmarks(pyrd))
        conf_p, conf_r = prog["conf_matrix_pred"], ref["conf_matrix_pred"]
        out["conf"] = float((conf_p - conf_r).abs().max())
        out["match_flips"] = float(_match_flips(
            prog, ref, conf_r, self.ref_lcfg.matcher.matching
            .confidence_threshold))

        # NeCo: the reference on the program's matches
        prog = it.out
        with precision.mode("f32"), torch.no_grad():
            neco_r = ref_landmark.neco_filter(self.params, prog,
                                              self.ref_lcfg)
        if ctrl:
            with _tf32(ctrl), torch.no_grad():
                prog = ref_landmark.neco_filter(self.params, prog,
                                                self.ref_lcfg)
        valid = prog["vec_6d_mask"]
        cp, cr = prog["neco_confidence"], neco_r["neco_confidence"]
        out["neco"] = float((cp - cr)[valid].abs().max()) \
            if bool(valid.any()) else 0.0
        flip = (prog["ldmk_valid"] != neco_r["ldmk_valid"]) \
            & ((cr - cfg["inlier_thr"]).abs() > TIE)
        out["landmark_flips"] = float(flip.sum())

        # the solve: every level followed from the program's own state,
        # with the program's landmarks as the targets
        src, tgt, sv, tv = it.inputs
        src_mean = ref_ndp.masked_mean(src, sv)
        tgt_mean = ref_ndp.masked_mean(tgt, tv)
        y = it.out["ldmk_t"] - tgt_mean
        valid = it.out["ldmk_valid"]
        levels = it.levels or []
        parted = []
        if len(levels) != cfg["m"]:
            # the port's level loop was not seen: nothing to compare
            out["solve_loss"] = out["solve_change"] = math.inf
        else:
            out["solve_loss"] = out["solve_change"] = 0.0
        final = {k: {kk: vv.clone() for kk, vv in v.items()}
                 for k, v in self.init[it.index].items()}
        for lvl, p_in, x, (p_out, _, stats) in levels:
            for k, v in p_out.items():
                for kk, vv in v.items():
                    final[k][kk][lvl] = vv
            n = int(stats["iters"])
            with precision.mode("f32"):
                ref_l = ref_ndp.landmark_level(p_in, lvl, x, y, valid, n, cfg)
                exact = ref_ndp.landmark_level(
                    _double(p_in), lvl, x.double(), y.double(), valid, n,
                    cfg)
            if _change_gap(p_in, ref_l["params"], exact["params"]) > WITNESS:
                parted.append(lvl)
                continue
            got_loss, got_p = float(stats["loss"]), p_out
            if ctrl:
                with _tf32(ctrl):
                    ctl = ref_ndp.landmark_level(p_in, lvl, x, y, valid, n,
                                                 cfg)
                got_loss, got_p = ctl["last_loss"], ctl["params"]
            out["solve_loss"] = max(
                out["solve_loss"], abs(got_loss - ref_l["last_loss"])
                / max(ref_l["first_loss"], 1e-30))
            out["solve_change"] = max(
                out["solve_change"], _change_gap(p_in, got_p, ref_l["params"]))
        # the answer: the reference's warp of the program's final pyramid
        n_src = len(pair.src)
        want = ref_ndp.warp(final, (src - src_mean)[:n_src], cfg) + tgt_mean
        warped = it.warped[:n_src]
        if ctrl:
            with _tf32(ctrl):
                warped = ref_ndp.warp(final, (src - src_mean)[:n_src],
                                      cfg) + tgt_mean
        out["answer"] = float((warped - want).abs().max())
        self.per_pair.append({"cluster": pair.cluster,
                              "iters": it.iters.tolist(),
                              "landmarks": int(it.n_ldmk),
                              "levels_parted": parted, **out})
        return out

    def _to_device(self, pyr) -> dict:
        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return (t.long() if t.dtype == torch.int32 else t).to(
                self.device)

        pyrd = {key: [put(a) for a in getattr(pyr, key)]
                for key in ("points", "valids", "neighbors", "pools",
                            "upsamples")}
        pyrd["features"] = put(pyr.features)
        pyrd["_lengths"] = (pyr.src_lengths, pyr.tgt_lengths)
        return pyrd


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.detach().clone()


def _double(tree: dict) -> dict:
    return {k: {kk: vv.double() for kk, vv in v.items()}
            for k, v in tree.items()}


def _change_gap(p0: dict, prog: dict, ref: dict) -> float:
    """A level's change of its parameters: the gap between the program's
    norm and the reference's, by the worst leaf, over the larger of the
    reference's norm of that leaf and of the median leaf (in float64)."""
    keys = [(k, kk) for k in ref for kk in ref[k]]
    pn = [float((prog[k][kk].double() - p0[k][kk].double()).norm())
          for k, kk in keys]
    rn = [float((ref[k][kk].double() - p0[k][kk].double()).norm())
          for k, kk in keys]
    med = float(np.median(rn))
    return max(abs(a - b) / max(b, med, 1e-30) for a, b in zip(pn, rn))


def _set_flips(a: np.ndarray, b: np.ndarray, q: np.ndarray,
               s: np.ndarray) -> int:
    """Rows whose neighbour sets differ beyond a tie: every index in one
    set and not the other lies within 1e-5 (relative) of the farthest
    neighbour of the two rows (a point on the search radius, or tied with
    the last one kept)."""
    sa, sb = np.sort(a, 1), np.sort(b, 1)
    bad = 0
    for r in np.nonzero((sa != sb).any(1))[0]:
        ia = {int(i) for i in a[r] if i < len(s)}
        ib = {int(i) for i in b[r] if i < len(s)}
        union = np.fromiter(ia | ib, np.int64)
        diff = np.fromiter(ia ^ ib, np.int64)
        if len(diff) == 0:
            continue
        d_all = np.linalg.norm(s[union].astype(np.float64) - q[r], axis=1)
        d_diff = np.linalg.norm(s[diff].astype(np.float64) - q[r], axis=1)
        if np.any(np.abs(d_diff - d_all.max()) > 1e-5 * d_all.max()):
            bad += 1
    return bad


class _tf32:
    """The control's precision: the reference's products one step below
    float32, on the card's TF32 tensor cores (and the operand rounding of
    ``precision`` where the reference routes a product through it)."""

    def __init__(self, name: str):
        self.name = name
        self._mode = precision.mode(name)

    def __enter__(self):
        self._mode.__enter__()
        self.prev = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.prev
        self._mode.__exit__(*exc)


def _match_flips(prog: dict, ref: dict, conf: torch.Tensor,
                 thr: float) -> int:
    """Rows whose mutual-max match differs between the program and the
    reference, beyond rows where the reference's confidence leaves the
    decision within ``TIE`` (the two candidates, or the threshold)."""
    pv, rv = prog["match_valid"], ref["match_valid"]
    pi, ri = prog["match_idx"][:, 1], ref["match_idx"][:, 1]
    differ = (pv != rv) | (pv & rv & (pi != ri))
    if not bool(differ.any()):
        return 0
    rows = torch.nonzero(differ)[:, 0]
    c = conf[rows]
    best = c.max(dim=1).values
    near = (best - c.gather(1, pi[rows, None])[:, 0]).abs() <= TIE
    near |= (best - thr).abs() <= TIE
    # the column test: the row's best column has a near-equal rival row
    col = conf[:, ri[rows]]
    top2 = col.topk(2, dim=0).values
    near |= (top2[0] - top2[1]).abs() <= TIE
    return int((~near).sum())
