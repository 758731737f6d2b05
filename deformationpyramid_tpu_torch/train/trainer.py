"""Training loops for the matcher and the outlier-rejection (NeCo) model.

Counterpart of ``deformationpyramid_tpu/train/trainer.py`` (reference
``correspondence/lib/trainer.py:17-276`` + ``correspondence/main.py:75-103``):
the matcher trains with MatchMotionLoss; NeCo trains with class-balanced BCE
while the matcher runs frozen; SGD (momentum + weight decay) or Adam with an
exponential / multi-step LR schedule; gradient accumulation over
``iter_size`` (summed gradients, one optimizer step every ``iter_size``
batches); a NaN/Inf gradient guard; best-loss snapshots selected on the
validation split when one is given; per-epoch scalar history JSONL.

Same names and call shapes as the JAX package: parameters and optimizer
state are trees of tensors that a step takes and returns (nothing is updated
in place), and the steps are plain closures. The optimizer is a small
functional one over the tree that does, leaf for leaf, what the JAX
package's optax chain does: weight decay is added to EVERY leaf's gradient
before Adam / SGD, also to a leaf whose gradient is exactly zero (the
KPConv ``kernel_points`` buffers sit in the matcher tree and are read
detached), so such a leaf moves as it does there.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..match.landmark import LandmarkConfig, trainable
from ..match.losses import MatchLossConfig, match_motion_loss, neco_loss
from ..match.outlier_rejection import apply_neco
from ..match.pipeline import apply_matcher
from ..models.pyramid import tree_leaves, tree_map
from ..utils import timers
from ..utils.checkpoint import save_pytree
from ..utils.logging import AverageMeter

Tensor = torch.Tensor

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "SGD"           # 'SGD' | 'Adam'
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 1e-6
    scheduler: str = "ExpLR"         # 'ExpLR' | 'MultiStepLR'
    scheduler_gamma: float = 0.99    # per-epoch decay (ExpLR) / step scale
    lr_milestones: tuple[int, ...] = ()  # epochs, MultiStepLR only
    iter_size: int = 1               # gradient accumulation
    max_epoch: int = 10
    grad_clip: float | None = None
    inlier_thr: float = 0.1
    snapshot_dir: str = "snapshot/neco"


def make_schedule(cfg: TrainConfig, steps_per_epoch: int
                  ) -> Callable[[Tensor | int], Tensor]:
    """LR schedule in optimizer-update steps (the reference steps its
    scheduler once per epoch, ``lib/trainer.py:255``): a function of the
    step count (an int or a 0-d tensor, which stays on its device) that
    returns the rate as a 0-d float32 tensor.

    'MultiStepLR' scales by gamma from each milestone epoch on
    (``correspondence/main.py:90-97``); 'ExpLR' decays by gamma per epoch,
    as a staircase (``main.py:99-103``).
    """
    spe = max(steps_per_epoch, 1)
    if cfg.scheduler not in ("MultiStepLR", "ExpLR"):
        raise KeyError(cfg.scheduler)
    bounds = sorted(int(m) * spe for m in cfg.lr_milestones)

    def schedule(count: Tensor | int) -> Tensor:
        count = torch.as_tensor(count)
        lr = torch.full((), cfg.lr, dtype=torch.float32, device=count.device)
        if cfg.scheduler == "MultiStepLR":
            for threshold in bounds:
                lr = torch.where(count < threshold, lr,
                                 lr * cfg.scheduler_gamma)
            return lr
        epochs = torch.floor(count.to(torch.float32) / spe)
        gamma = torch.full_like(lr, cfg.scheduler_gamma)
        return torch.where(count <= 0, lr, lr * torch.pow(gamma, epochs))

    return schedule


class Optimizer:
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, state)`` over trees of tensors: global-norm clipping where
    set, then weight decay added to every leaf's gradient, then Adam or SGD
    with momentum, scaled by minus the schedule's rate at the state's count.
    The state is a dict of trees and a 0-d count on the parameters' device."""

    def __init__(self, cfg: TrainConfig, steps_per_epoch: int):
        if cfg.optimizer not in ("SGD", "Adam"):
            raise KeyError(cfg.optimizer)
        self.cfg = cfg
        self.schedule = make_schedule(cfg, steps_per_epoch)

    def init(self, params: Any) -> dict:
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        count = torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device)
        if self.cfg.optimizer == "Adam":
            return {"count": count, "mu": zeros(), "nu": zeros()}
        return {"count": count, "trace": zeros()}

    @torch.no_grad()
    def update(self, grads: Any, state: dict, params: Any
               ) -> tuple[Any, dict]:
        cfg = self.cfg
        if cfg.grad_clip is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in tree_leaves(grads)))
            grads = tree_map(lambda g: torch.where(
                norm < cfg.grad_clip, g, g / norm * cfg.grad_clip), grads)
        grads = tree_map(lambda g, p: g + cfg.weight_decay * p, grads, params)
        count = state["count"]
        step = -self.schedule(count)
        new_count = count + 1
        if cfg.optimizer == "Adam":
            mu = tree_map(lambda g, m: (1 - ADAM_B1) * g + ADAM_B1 * m,
                          grads, state["mu"])
            nu = tree_map(lambda g, v: (1 - ADAM_B2) * (g * g) + ADAM_B2 * v,
                          grads, state["nu"])
            steps = new_count.to(torch.float32)
            c1 = 1 - torch.pow(torch.full_like(steps, ADAM_B1), steps)
            c2 = 1 - torch.pow(torch.full_like(steps, ADAM_B2), steps)
            updates = tree_map(
                lambda m, v: step * ((m / c1) / (torch.sqrt(v / c2)
                                                 + ADAM_EPS)), mu, nu)
            return updates, {"count": new_count, "mu": mu, "nu": nu}
        trace = tree_map(lambda g, t: g + cfg.momentum * t, grads,
                         state["trace"])
        return (tree_map(lambda t: step * t, trace),
                {"count": new_count, "trace": trace})


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int) -> Optimizer:
    return Optimizer(cfg, steps_per_epoch)


def valid_gradient(grads: Any) -> Tensor:
    """NaN/Inf gradient guard (reference ``lib/utils.py:103-113``): one 0-d
    bool tensor over all leaves, left on the device."""
    return torch.stack([torch.isfinite(g).all()
                        for g in tree_leaves(grads)]).all()


def _keep(ok: Tensor, new: Any, old: Any) -> Any:
    return tree_map(lambda a, b: torch.where(ok, a, b), new, old)


def value_and_grad(loss_fn, params: Any):
    """``(loss, info), grads`` of ``loss_fn(p) -> (loss, info)`` at
    ``params``, all detached (``jax.value_and_grad(..., has_aux=True)``); a
    leaf the loss does not depend on gets a zero gradient, as there."""
    p = trainable(params)
    loss, info = loss_fn(p)
    leaves = tree_leaves(p)
    got = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    grads = tree_map(lambda t: next(got), p)
    grads = tree_map(lambda g, t: torch.zeros_like(t) if g is None else g,
                     grads, p)
    info = {k: v.detach() if isinstance(v, Tensor) else v
            for k, v in info.items()}
    return (loss.detach(), info), grads


def make_neco_loss_fn(matcher_params: dict, lcfg: LandmarkConfig,
                      s_cap: int | None = None, t_cap: int | None = None):
    """Matcher-frozen NeCo loss for one pair (``lib/trainer.py:117-139``):
    the matcher runs under ``no_grad`` and its outputs enter NeCo detached.

    ``s_cap``/``t_cap``: static per-cloud coarse caps (see
    ``match.pipeline.apply_matcher``); without them the frozen matcher
    forward pads both clouds to the full stacked coarse size.
    """

    def loss_fn(neco_params, pyramid, src_len_c, tgt_len_c, coarse_flow,
                gt_rot, gt_trn):
        with torch.no_grad():
            data = apply_matcher(matcher_params, pyramid, src_len_c,
                                 tgt_len_c, lcfg.matcher,
                                 s_cap=s_cap, t_cap=t_cap)
        conf = apply_neco(neco_params, data["vec_6d"], data["vec_6d_mask"],
                          lcfg.neco)
        loss, info = neco_loss(conf, data["vec_6d"], data["vec_6d_mask"],
                               data["vec_6d_ind"], data["s_pcd"], coarse_flow,
                               gt_rot, gt_trn)
        return loss, info

    return loss_fn


def make_neco_train_step(matcher_params: dict, lcfg: LandmarkConfig,
                         opt: Optimizer,
                         s_cap: int | None = None, t_cap: int | None = None):
    """Build the (loss, grads, update) step for one pair. As in the JAX
    package, a step whose gradient is not finite keeps the parameters and
    takes an optimizer step on a zero gradient."""
    loss_fn = make_neco_loss_fn(matcher_params, lcfg, s_cap=s_cap,
                                t_cap=t_cap)

    def step(neco_params, opt_state, pyramid, src_len_c, tgt_len_c,
             coarse_flow, gt_rot, gt_trn):
        (loss, info), grads = value_and_grad(
            lambda p: loss_fn(p, pyramid, src_len_c, tgt_len_c, coarse_flow,
                              gt_rot, gt_trn), neco_params)
        with torch.no_grad():
            ok = valid_gradient(grads)
            grads = tree_map(lambda g: torch.where(ok, g, 0.0), grads)
            updates, opt_state = opt.update(grads, opt_state, neco_params)
            new_params = tree_map(torch.add, neco_params, updates)
            return (_keep(ok, new_params, neco_params), opt_state, loss,
                    info, ok)

    return step


def make_neco_accum_fns(matcher_params: dict, lcfg: LandmarkConfig,
                        opt: Optimizer,
                        s_cap: int | None = None, t_cap: int | None = None):
    """(grads_fn, apply_fn) pair implementing ``iter_size`` accumulation.

    Mirrors the reference exactly (``lib/trainer.py:185-201``): per-batch
    ``backward()`` SUMS gradients into the accumulator (no 1/iter_size
    scaling), the optimizer steps once every ``iter_size`` batches, the
    NaN/Inf guard runs on the ACCUMULATED gradient at step time and skips
    the whole step, optimizer state included, when it fails (the buffer is
    cleared either way).
    """
    loss_fn = make_neco_loss_fn(matcher_params, lcfg, s_cap=s_cap,
                                t_cap=t_cap)

    def grads_fn(neco_params, accum, pyramid, src_len_c, tgt_len_c,
                 coarse_flow, gt_rot, gt_trn):
        (loss, info), grads = value_and_grad(
            lambda p: loss_fn(p, pyramid, src_len_c, tgt_len_c, coarse_flow,
                              gt_rot, gt_trn), neco_params)
        accum = tree_map(torch.add, accum, grads)
        return accum, loss, info

    @torch.no_grad()
    def apply_fn(neco_params, opt_state, accum):
        ok = valid_gradient(accum)
        updates, new_opt_state = opt.update(accum, opt_state, neco_params)
        new_params = tree_map(torch.add, neco_params, updates)
        zeros = tree_map(torch.zeros_like, accum)
        return (_keep(ok, new_params, neco_params),
                _keep(ok, new_opt_state, opt_state), zeros, ok)

    return grads_fn, apply_fn


def make_matcher_train_step(lcfg: LandmarkConfig, opt: Optimizer,
                            s_cap: int | None = None,
                            t_cap: int | None = None,
                            loss_cfg: MatchLossConfig = MatchLossConfig()):
    """MatchMotionLoss step training the FULL matcher.

    The reference trains its matcher in the upstream Lepard repo and ships
    checkpoints (``landmark_estimator.py:33-39``); here the training
    surface is first-class so the end-to-end system can be shown to learn
    without external weights (focal + rigid-motion loss semantics per
    ``lepard/loss.py:80-188``). A step whose gradient is not finite keeps
    the parameters and the optimizer state.
    """

    def step(matcher_params, opt_state, pyramid, src_len_c, tgt_len_c,
             match_gt, match_gt_valid, coarse_flow, gt_rot, gt_trn):
        def loss_fn(mp):
            data = apply_matcher(mp, pyramid, src_len_c, tgt_len_c,
                                 lcfg.matcher, s_cap=s_cap, t_cap=t_cap)
            return match_motion_loss(data, match_gt, match_gt_valid,
                                     coarse_flow, gt_rot, gt_trn, loss_cfg)

        with timers.span("dp::train.step"):
            (loss, info), grads = value_and_grad(loss_fn, matcher_params)
            with torch.no_grad(), timers.span("dp::train.update"):
                ok = valid_gradient(grads)
                grads = tree_map(lambda g: torch.where(ok, g, 0.0), grads)
                updates, new_opt_state = opt.update(grads, opt_state,
                                                    matcher_params)
                new_params = tree_map(torch.add, matcher_params, updates)
                return (_keep(ok, new_params, matcher_params),
                        _keep(ok, new_opt_state, opt_state), loss, info, ok)

    return step


def train_matcher(matcher_params: dict, lcfg: LandmarkConfig,
                  cfg: TrainConfig,
                  train_batches: Callable[[], Iterable[dict]],
                  steps_per_epoch: int, log_fn=print) -> dict:
    """Matcher training loop (MatchMotionLoss, per-pair steps).

    ``train_batches()`` yields dicts with pyramid/src_len_c/tgt_len_c/
    match_gt/match_gt_valid/coarse_flow/gt_rot/gt_trn on the parameters'
    device and STATIC ``s_cap``/``t_cap`` ints. Every step reads its loss,
    recall, precision and guard flag on the host (one synchronise a step).
    """
    opt = make_optimizer(cfg, steps_per_epoch)
    opt_state = opt.init(matcher_params)
    steps: dict[tuple[int, int], Any] = {}

    log_fn(f"training matcher: {cfg.max_epoch} epochs x {steps_per_epoch} "
           "steps")
    os.makedirs(cfg.snapshot_dir, exist_ok=True)
    history_path = f"{cfg.snapshot_dir}/history.jsonl"
    best = np.inf
    for epoch in range(cfg.max_epoch):
        meter = AverageMeter()
        rec = AverageMeter()
        prec = AverageMeter()
        for batch in train_batches():
            caps = (int(batch["s_cap"]), int(batch["t_cap"]))
            if caps not in steps:
                steps[caps] = make_matcher_train_step(
                    lcfg, opt, s_cap=caps[0], t_cap=caps[1])
            matcher_params, opt_state, loss, info, ok = steps[caps](
                matcher_params, opt_state, batch["pyramid"],
                batch["src_len_c"], batch["tgt_len_c"], batch["match_gt"],
                batch["match_gt_valid"], batch["coarse_flow"],
                batch["gt_rot"], batch["gt_trn"])
            if not bool(ok):
                log_fn("gradient not valid")
            meter.update(float(loss))
            rec.update(float(info["recall_coarse"]))
            prec.update(float(info["precision_coarse"]))
        log_fn(f"epoch {epoch}: match loss {meter.avg:.4f} "
               f"recall {rec.avg:.3f} precision {prec.avg:.3f}")
        with open(history_path, "a") as f:
            f.write(json.dumps({
                "epoch": epoch, "phase": "train", "loss": meter.avg,
                "recall_coarse": rec.avg, "precision_coarse": prec.avg,
            }) + "\n")
        if meter.avg < best:
            best = meter.avg
            save_pytree(f"{cfg.snapshot_dir}/matcher_best_loss.npz",
                        matcher_params, meta={"epoch": epoch, "loss": best})
        save_pytree(f"{cfg.snapshot_dir}/matcher_last.npz", matcher_params,
                    meta={"epoch": epoch, "loss": meter.avg})
    return matcher_params


def make_neco_eval_step(matcher_params: dict, lcfg: LandmarkConfig,
                        s_cap: int | None = None, t_cap: int | None = None):
    """Loss-only step for the validation split (no update, no graph)."""
    loss_fn = make_neco_loss_fn(matcher_params, lcfg, s_cap=s_cap,
                                t_cap=t_cap)

    @torch.no_grad()
    def step(neco_params, pyramid, src_len_c, tgt_len_c, coarse_flow,
             gt_rot, gt_trn):
        return loss_fn(neco_params, pyramid, src_len_c, tgt_len_c,
                       coarse_flow, gt_rot, gt_trn)

    return step


def _batch_args(batch: dict) -> tuple:
    return (batch["pyramid"], batch["src_len_c"], batch["tgt_len_c"],
            batch["coarse_flow"], batch["gt_rot"], batch["gt_trn"])


def train_neco(matcher_params: dict, neco_params: dict, lcfg: LandmarkConfig,
               cfg: TrainConfig, train_batches: Callable[[], Iterable[dict]],
               steps_per_epoch: int, log_fn=print,
               val_batches: Callable[[], Iterable[dict]] | None = None
               ) -> dict:
    """Epoch loop; ``train_batches()`` yields dicts on the parameters'
    device with keys pyramid/src_len_c/tgt_len_c/coarse_flow/gt_rot/gt_trn.

    Model selection mirrors the reference (``lib/trainer.py:246-274``):
    when ``val_batches`` is given, the best-loss snapshot tracks the
    validation loss after each epoch; otherwise the train loss (the
    reference's 'overfit' path). Per-epoch scalars (loss, IR_neco, lr per
    phase) append to ``<snapshot_dir>/history.jsonl``.
    """
    opt_steps_per_epoch = max(steps_per_epoch // max(cfg.iter_size, 1), 1)
    opt = make_optimizer(cfg, opt_steps_per_epoch)
    sched = make_schedule(cfg, opt_steps_per_epoch)
    opt_state = opt.init(neco_params)
    # one grads/eval closure per static coarse-cap pair (batches carry
    # optional "s_cap"/"t_cap" ints)
    grads_fns: dict[tuple, Any] = {}
    eval_steps: dict[tuple, Any] = {}
    apply_fn_box: list = []

    def get_grads_fn(batch):
        caps = (batch.get("s_cap"), batch.get("t_cap"))
        if caps not in grads_fns:
            g, a = make_neco_accum_fns(matcher_params, lcfg, opt,
                                       s_cap=caps[0], t_cap=caps[1])
            grads_fns[caps] = g
            if not apply_fn_box:
                apply_fn_box.append(a)  # caps-independent
        return grads_fns[caps]

    def get_eval_step(batch):
        caps = (batch.get("s_cap"), batch.get("t_cap"))
        if caps not in eval_steps:
            eval_steps[caps] = make_neco_eval_step(
                matcher_params, lcfg, s_cap=caps[0], t_cap=caps[1])
        return eval_steps[caps]

    os.makedirs(cfg.snapshot_dir, exist_ok=True)
    history_path = f"{cfg.snapshot_dir}/history.jsonl"

    def write_history(epoch: int, phase: str, meters: dict[str, AverageMeter],
                      n_opt_steps: int) -> None:
        row = {"epoch": epoch, "phase": phase,
               "lr": float(sched(n_opt_steps))}
        row.update({k: m.avg for k, m in meters.items()})
        with open(history_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    best = np.inf
    n_opt_steps = 0
    # the gradient buffer persists across epoch boundaries, as the
    # reference's does (zero_grad only runs at step time, trainer.py:200)
    accum = tree_map(torch.zeros_like, neco_params)
    c_iter = 0
    for epoch in range(cfg.max_epoch):
        meter = AverageMeter()
        ir_meter = AverageMeter()
        for batch in train_batches():
            accum, loss, info = get_grads_fn(batch)(neco_params, accum,
                                                    *_batch_args(batch))
            c_iter += 1
            if c_iter % max(cfg.iter_size, 1) == 0:
                neco_params, opt_state, accum, ok = apply_fn_box[0](
                    neco_params, opt_state, accum)
                n_opt_steps += 1
                if not bool(ok):
                    log_fn("gradient not valid")
            meter.update(float(loss))
            ir_meter.update(float(info["IR_neco"]))
        log_fn(f"epoch {epoch}: loss {meter.avg:.4f} "
               f"IR_neco {ir_meter.avg:.3f}")
        write_history(epoch, "train",
                      {"loss": meter, "IR_neco": ir_meter}, n_opt_steps)

        select_loss = meter.avg
        if val_batches is not None:
            v_meter = AverageMeter()
            v_ir = AverageMeter()
            for batch in val_batches():
                v_loss, v_info = get_eval_step(batch)(neco_params,
                                                      *_batch_args(batch))
                v_meter.update(float(v_loss))
                v_ir.update(float(v_info["IR_neco"]))
            log_fn(f"epoch {epoch}: val loss {v_meter.avg:.4f} "
                   f"IR_neco {v_ir.avg:.3f}")
            write_history(epoch, "val",
                          {"loss": v_meter, "IR_neco": v_ir}, n_opt_steps)
            select_loss = v_meter.avg

        if select_loss < best:
            best = select_loss
            save_pytree(f"{cfg.snapshot_dir}/model_best_loss.npz", neco_params,
                        meta={"epoch": epoch, "loss": best})
        save_pytree(f"{cfg.snapshot_dir}/model_last.npz", neco_params,
                    meta={"epoch": epoch, "loss": meter.avg})
    return neco_params
