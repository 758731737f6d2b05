"""Matcher training, ``cli/train_matcher.py``'s step: ``make_matcher_train_step``
with Adam on the streamed attention route (C7 forward, C8 and C9
backward), one pair a step.

The data is the training split of ``scripts/make_suites.py`` (``pairs``
pairs at the ``size`` cluster; its seed folded with ``--seed``), collated
in set-up and kept on the card, as the CLI's cache does, and cycled in a
seeded order. Set-up builds the one training object (weights, optimizer
state, the step of each coarse cap), drives it through its first
``follow`` steps on distinct pairs, and hands that same object to the
window. Every step reads its loss on the host, as the CLI does.

``train_pairs_per_s``: steps in the window over the window (up to the
synchronise after the last).

What decides ``correct``: the reference follows the first ``follow``
steps from the same weights on batches it works out again from the raw
pairs: the first step's loss; the first step's gradient as the optimizer
takes it (the program's from its Adam moment after one step), as the gap
between the two norms of a leaf by the worst leaf, over the larger of the
reference's norm of that leaf and of the median leaf; and the
parameters' change after the last step, as that gap over the reference's
norm of the leaf, by the median leaf. Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone and are
left out of the change.
"""
from __future__ import annotations

import itertools
import math
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark import core, ranges
from benchmark.drivers.lndp_register import (attention_bound_s,
                                             program_landmark_config,
                                             ref_landmark_config)
from benchmark.reference import collate as ref_collate
from benchmark.reference import precision
from benchmark.reference import train as ref_train
from benchmark.reference.match.backbone import KPFCN_ARCHITECTURE
from benchmark.reference.tree import tree_leaves, tree_map
from benchmark.traffic.synthetic import fourdmatch_pair
from benchmark.weights import landmark_weights

LIMITS = {"loss": 1e-5, "grad": 5e-3, "change": 3e-3}
# Adam's first step moves every value by the rate times the sign of its
# gradient, so values whose gradient is round-off move either way: the
# losses of the later steps and the worst leaf's change carry that noise
# (PERF.md). The first step's loss and the median leaf's change do not.


class Driver:
    def __init__(self, run: core.Run, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, control: str | None = None):
        self.run, self.cfg, self.traffic = run, cfg, traffic
        self.seed, self.device, self.control = seed, device, control
        self.attempted = 0
        self.failed = 0

    def setup(self) -> None:
        from deformationpyramid_tpu_torch.data import collate
        from deformationpyramid_tpu_torch.data.correspondence_utils import (
            blend_scene_flow, mutual_nn_correspondence)
        from deformationpyramid_tpu_torch.match.backbone import \
            KPFCN_ARCHITECTURE as ARCH
        from deformationpyramid_tpu_torch.train import trainer

        self.collate, self.arch, self.trainer = collate, ARCH, trainer
        self.blend, self.mutual = blend_scene_flow, mutual_nn_correspondence
        t, cfg = self.traffic, self.cfg
        run = self.run
        self.lcfg = program_landmark_config(cfg)
        self.ref_lcfg = ref_landmark_config(cfg)
        with run.span("setup.weights"):
            weights = landmark_weights(self.ref_lcfg, self.seed, self.device)
        self.p0 = weights["matcher"]
        del weights
        with run.span("setup.pairs"):
            rng = np.random.default_rng([int(t["split_seed"]), self.seed])
            seeds = rng.integers(0, 1 << 62, size=int(t["pairs"]))
            self.pairs = [fourdmatch_pair(int(t["size"]), int(s),
                                          partial=t["partial"],
                                          deform=t["deform"]) for s in seeds]
            self.order = rng.permutation(len(self.pairs)).tolist()
        with run.span("setup.calibrate"):
            self.limits = collate.calibrate_neighborhood_limits(
                [(p.src, p.tgt) for p in self.pairs[:3]],
                self.lcfg.matcher.kpfcn, ARCH)
        with run.span("setup.collate"), \
                ThreadPoolExecutor(int(t["collate_threads"])) as pool:
            self.batches = list(pool.map(self._batch, self.pairs))
        self.tcfg = trainer.TrainConfig(
            max_epoch=1, optimizer="Adam", lr=cfg["train_lr"],
            weight_decay=cfg["weight_decay"], scheduler="ExpLR",
            scheduler_gamma=cfg["scheduler_gamma"])
        self.opt = trainer.make_optimizer(self.tcfg, len(self.pairs))
        self._wrap()
        self.steps = {}
        self.params = self.p0
        self.state = self.opt.init(self.params)
        self.queue = itertools.cycle(self.order)
        # the first steps, on distinct pairs, which the reference follows
        self.followed = []
        with run.span("setup.follow"):
            for k in range(int(t["follow"])):
                i = next(self.queue)
                loss = self._step(self.batches[i])
                self.followed.append((i, loss))
                if k == 0:
                    self.state1 = self.state
        self.p_follow = self.params

    def _batch(self, pair) -> dict:
        """The CLI's training batch of one pair (``make_matcher_batch_stream``
        with ``cache=True``), built with the program's collate."""
        collate, dev = self.collate, self.device
        cl = self.lcfg.matcher.coarse_level
        pyr = collate.build_pair_pyramid(pair.src, pair.tgt,
                                         self.lcfg.matcher.kpfcn, self.arch,
                                         self.limits, pad_to="pow2")
        s_len, t_len = pyr.src_lengths[cl], pyr.tgt_lengths[cl]
        cap = collate.pow2_cap(max(s_len, t_len))
        coarse = pyr.points[cl]
        c_src, c_tgt = coarse[:s_len], coarse[s_len:s_len + t_len]
        flow_gt = (pair.rot @ (pair.src + pair.flow).T + pair.trans).T \
            - pair.src
        flow_def = (pair.rot.T @ (flow_gt + pair.src - pair.trans.T).T).T \
            - pair.src
        c_flow = self.blend(c_src, pair.src, flow_def.astype(np.float32))
        warped = (pair.rot @ (c_src + c_flow).T + pair.trans).T
        corr = self.mutual(warped, c_tgt,
                           search_radius=self.cfg["matcher"]["kpfcn_config"]
                           ["coarse_match_radius"])
        match_gt = np.zeros((cap, 2), np.int64)
        match_gt_valid = np.zeros((cap,), bool)
        m = min(len(corr), cap)
        match_gt[:m] = corr[:m]
        match_gt_valid[:m] = True
        coarse_flow = np.zeros((cap, 3), np.float32)
        coarse_flow[:s_len] = c_flow

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return {"pyramid": collate.pyramid_to_device(pyr, dev),
                "src_len_c": torch.tensor(s_len, dtype=torch.int32,
                                          device=dev),
                "tgt_len_c": torch.tensor(t_len, dtype=torch.int32,
                                          device=dev),
                "match_gt": put(match_gt), "match_gt_valid": put(match_gt_valid),
                "coarse_flow": put(coarse_flow), "gt_rot": put(pair.rot),
                "gt_trn": put(pair.trans), "s_cap": cap, "t_cap": cap,
                "s_len": int(s_len), "t_len": int(t_len)}

    def _wrap(self) -> None:
        """``bench::optimizer`` around the optimizer's update; in the traced
        run ``bench::attention`` around every streamed attention call."""
        run = self.run
        update = self.opt.update

        def timed_update(*a, **kw):
            with run.span("optimizer"):
                return update(*a, **kw)

        self.opt.update = timed_update
        self.attention_bound = 0.0
        if run.trace_requested:
            ranges.wrap_attention(run)

    def _step(self, batch: dict) -> float:
        caps = (batch["s_cap"], batch["t_cap"])
        if caps not in self.steps:
            self.steps[caps] = self.trainer.make_matcher_train_step(
                self.lcfg, self.opt, s_cap=caps[0], t_cap=caps[1])
        if self.run.tracing:
            # the forward's and the backward's least time over valid rows
            self.attention_bound += attention_bound_s(
                self.cfg, batch["s_len"], batch["t_len"], caps[0],
                backward=True)
        with self.run.span("step"):
            self.params, self.state, loss, info, ok = self.steps[caps](
                self.params, self.state, batch["pyramid"],
                batch["src_len_c"], batch["tgt_len_c"], batch["match_gt"],
                batch["match_gt_valid"], batch["coarse_flow"],
                batch["gt_rot"], batch["gt_trn"])
            return float(loss)

    def window(self, seconds: float) -> None:
        run = self.run
        trace_steps = int(self.traffic.get("trace_steps", 3))
        t0 = time.perf_counter()
        deadline = t0 + seconds
        steps, traced = 0, 0
        self.losses = []
        while time.perf_counter() < deadline:
            if steps == 1 and run.trace_requested and traced == 0:
                run.start_trace()
            self.losses.append(self._step(self.batches[next(self.queue)]))
            steps += 1
            if run.tracing:
                traced += 1
                if traced >= trace_steps:
                    run.stop_trace()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        run.stop_trace()
        self.window_s = time.perf_counter() - t0
        run.window_s = self.window_s
        self.n_steps = steps
        self.attempted = steps
        run.counters["traced_steps"] = float(traced)

    def after_window(self) -> None:
        """The traced run's counters that need the card once the window
        and its memory reading are over."""
        run = self.run
        if run.trace is not None:
            run.counters["attention_bound_s"] = self.attention_bound
        if run.trace_requested:
            run.counters["train_flops"] = self.n_steps * self._step_flops()

    def _step_flops(self) -> float:
        """FLOPs of one training step: the reference's forward and
        backward under ``FlopCounterMode``, at the cap most of the split
        has (the optimizer's elementwise work is not counted)."""
        from torch.utils.flop_counter import FlopCounterMode

        caps = [b["s_cap"] for b in self.batches]
        cap = max(set(caps), key=caps.count)
        i = caps.index(cap)
        batch = ref_train.make_batch(self.pairs[i], self.ref_lcfg,
                                     self.limits, self._radius(),
                                     self.device)
        counter = FlopCounterMode(display=False)
        with counter, precision.mode("f32"):
            ref_train.loss_and_grads(self.p0, batch, self.ref_lcfg)
        return float(counter.get_total_flops())

    def _radius(self) -> float:
        return self.cfg["matcher"]["kpfcn_config"]["coarse_match_radius"]

    def end_to_end(self) -> dict:
        return {"train_pairs_per_s": self.n_steps / self.window_s}

    def diagnostics(self) -> dict:
        spans = self.run.spans
        return {"window_s": self.window_s, "steps": self.n_steps,
                "step_ms": 1e3 * self.window_s / max(self.n_steps, 1),
                "caps": sorted({b["s_cap"] for b in self.batches}),
                "losses": self.losses[:4] + self.losses[-2:],
                "followed_losses": [l for _, l in self.followed],
                "readings": getattr(self, "readings", None),
                "span_ms": {k: 1e3 * float(np.mean(v))
                            for k, v in spans.items()}}

    def check(self) -> list[core.Check]:
        ref_limits = ref_collate.calibrate_neighborhood_limits(
            [(p.src, p.tgt) for p in self.pairs[:3]],
            self.ref_lcfg.matcher.kpfcn, KPFCN_ARCHITECTURE)
        batches = [ref_train.make_batch(self.pairs[i], self.ref_lcfg,
                                        ref_limits, self._radius(),
                                        self.device)
                   for i, _ in self.followed]
        args = (self.cfg["train_lr"], self.cfg["weight_decay"],
                self.cfg["scheduler_gamma"], len(self.pairs))
        with precision.mode("f32"):
            ref = ref_train.follow(self.p0, batches, self.ref_lcfg, *args)
        losses = [l for _, l in self.followed]
        g1 = tree_map(lambda m: m / (1 - ref_train.ADAM_B1),
                      self.state1["mu"])
        p3 = self.p_follow
        if self.control:
            from benchmark.drivers.lndp_register import _tf32
            with _tf32(self.control):
                ctl = ref_train.follow(self.p0, batches, self.ref_lcfg,
                                       *args)
            losses, g1, p3 = ctl["losses"], ctl["first_grad"], ctl["params"]
        loss_gaps = [abs(a - b) / max(abs(b), 1e-12)
                     for a, b in zip(losses, ref["losses"])]
        loss_gap = loss_gaps[0]
        gn_p = [float(x.norm()) for x in tree_leaves(g1)]
        gn_r = [float(x.norm()) for x in tree_leaves(ref["first_grad"])]
        grad_gap = _worst(gn_p, gn_r)
        p0 = tree_leaves(self.p0)
        ch_p = [float((a - b).norm()) for a, b in zip(tree_leaves(p3), p0)]
        ch_r = [float((a - b).norm())
                for a, b in zip(tree_leaves(ref["params"]), p0)]
        med_g = float(np.median(gn_r))
        keep = [g >= 1e-3 * med_g for g in gn_r]
        kept_p = [c for c, k in zip(ch_p, keep) if k]
        kept_r = [c for c, k in zip(ch_r, keep) if k]
        change_gap = _median_leaf(kept_p, kept_r)
        self.readings = {"loss_gaps": loss_gaps, "grad_worst": grad_gap,
                         "change_worst": _worst(kept_p, kept_r),
                         "change_median": change_gap,
                         "leaves_left_out": int(len(keep) - sum(keep))}
        checks = [core.Check("loss", loss_gap, LIMITS["loss"]),
                  core.Check("grad", grad_gap, LIMITS["grad"]),
                  core.Check("change", change_gap, LIMITS["change"])]
        finite = all(math.isfinite(l) for l in self.losses)
        self.failed = 0 if finite else sum(not math.isfinite(l)
                                           for l in self.losses)
        if not finite:
            checks.append(core.Check("window_losses_finite", 1.0, 0.0))
        return checks


def _worst(prog: list[float], ref: list[float]) -> float:
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    if not ref:
        return 0.0
    med = float(np.median(ref))
    return max(abs(p - r) / max(r, med, 1e-30) for p, r in zip(prog, ref))


def _median_leaf(prog: list[float], ref: list[float]) -> float:
    """The median over leaves of the gap between two norms, each over the
    reference's norm of that leaf."""
    if not ref:
        return 0.0
    return float(np.median([abs(p - r) / max(r, 1e-30)
                            for p, r in zip(prog, ref)]))
