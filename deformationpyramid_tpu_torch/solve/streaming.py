"""Continuous-batching (slot-refill) registration solver.

Counterpart of ``deformationpyramid_tpu/solve/streaming.py``, with its
names. Solver state lives in device tensors with a leading slot axis;
``multi_step`` advances every slot by ``k_inner`` iterations (done slots
are frozen no-ops) without reading anything back to the host; the host
polls the small ``done`` flags, harvests finished pairs and refills their
slots with fresh work, so that no pair waits for the slowest one of a
batch.

Semantics per pair are those of ``solve/registration.py``'s unfused
chamfer loop (the same early-stop rules, level transitions, Adam and the
level-carry quirk: the next level starts from the warp evaluated before
this level's final step), unrolled into explicit per-iteration state
stepping:

  state: params [B, m, ...] stacked, Adam moments (the active level's slice
  is updated), the level of each slot, per-level iteration and plateau
  counters, the active point set.

Where the JAX package vmaps one pair's step, the port writes the slot axis
out: every slot's level is a tensor, its level parameters are gathered per
slot, ``models/pyramid.level_warp`` takes them with that axis (a batched
product; the JAX package leaves the warp to XLA too), and
``ops/chamfer.truncated_chamfer`` takes the 1-NN of all B slots from one
launch of kernel C1 (``ops/knn.py nn_argmin_dual`` on [B, N, 3]), the
counterpart of the vmapped Pallas sweep. Gradients are autograd of the sum
of the slots' losses: the slots share no parameter, so each slot's
gradient is its own loss's.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..losses import bce_with_zeros_target
from ..models import pyramid
from ..models.pyramid import init_pyramid_params, level_warp, warp
from ..ops.chamfer import truncated_chamfer
from .registration import (SolverConfig, _as_generator, _masked_mean,
                           _random_subset)

Tensor = torch.Tensor

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def init_pair_state(gen: int | torch.Generator, src: Tensor, tgt: Tensor,
                    cfg: SolverConfig, src_valid: Tensor | None = None,
                    tgt_valid: Tensor | None = None) -> dict[str, Any]:
    """One pair's solver state, drawn from ``gen`` in the order of
    ``register_pair``'s preamble (the initial pyramid, then the source and
    the target subsets), so that one generator gives both the same start."""
    gen = _as_generator(gen)
    pcfg = cfg.pyramid
    dev = src.device
    n_src, n_tgt = src.shape[0], tgt.shape[0]
    if src_valid is None:
        src_valid = torch.ones(n_src, dtype=torch.bool, device=dev)
    if tgt_valid is None:
        tgt_valid = torch.ones(n_tgt, dtype=torch.bool, device=dev)
    params = init_pyramid_params(gen, pcfg, device=dev)
    src_mean = _masked_mean(src, src_valid)
    tgt_mean = _masked_mean(tgt, tgt_valid)
    src_c = src - src_mean
    tgt_c = tgt - tgt_mean
    s_sample, s_valid = _random_subset(gen, src_c, src_valid,
                                       min(cfg.samples, n_src))
    t_sample, t_valid = _random_subset(gen, tgt_c, tgt_valid,
                                       min(cfg.samples, n_tgt))

    def scalar(value, dtype):
        return torch.tensor(value, dtype=dtype, device=dev)

    return {
        "params": params,
        "adam_m": pyramid.tree_map(torch.zeros_like, params),
        "adam_v": pyramid.tree_map(torch.zeros_like, params),
        "adam_t": scalar(0, torch.int32),
        "pts": s_sample,
        "pts_valid": s_valid,
        "t_sample": t_sample,
        "t_valid": t_valid,
        "level": scalar(0, torch.int32),
        "loss_prev": scalar(1e6, torch.float32),
        "counter": scalar(0, torch.int32),
        "it": scalar(0, torch.int32),
        "done": scalar(False, torch.bool),
        "loss": scalar(float("inf"), torch.float32),
        "total_iters": scalar(0, torch.int32),
        "src_c": src_c,
        "src_valid": src_valid,
        "tgt_mean": tgt_mean[0],
    }


def stack_states(states: Sequence[dict]) -> dict:
    """Pair states -> one state with a leading slot axis."""
    return pyramid.tree_map(lambda *xs: torch.stack(xs), *states)


def _per_slot(flag: Tensor, like: Tensor) -> Tensor:
    """A [B] tensor viewed to broadcast against ``like`` [B, ...]."""
    return flag.view((-1,) + (1,) * (like.dim() - 1))


def _slice_at(tree, level: Tensor):
    rows = torch.arange(level.shape[0], device=level.device)
    return pyramid.tree_map(lambda a: a[rows, level], tree)


def _put_at(tree, level: Tensor, new):
    def put(a, x):
        sel = torch.arange(a.shape[1], device=a.device)[None, :] \
            == level[:, None]
        return torch.where(sel.view(sel.shape + (1,) * (a.dim() - 2)),
                           x[:, None], a)
    return pyramid.tree_map(put, tree, new)


def _pair_step(state: dict[str, Any], cfg: SolverConfig) -> dict[str, Any]:
    """One solver iteration of every slot (a frozen no-op where done)."""
    pcfg = cfg.pyramid
    lvl = state["level"]
    p_l = _slice_at(state["params"], lvl)
    with torch.enable_grad():
        leaves = pyramid.tree_map(lambda a: a.detach().requires_grad_(True),
                                  p_l)
        warped, nr = level_warp(leaves, state["pts"], lvl, pcfg)
        loss = truncated_chamfer(warped, state["t_sample"],
                                 state["pts_valid"], state["t_valid"],
                                 trunc=1e9)
        if cfg.w_reg > 0:
            reg = bce_with_zeros_target(nr, state["pts_valid"])
            loss = loss + torch.where(lvl > 0, cfg.w_reg * reg, 0.0)
        flat = torch.autograd.grad(loss.sum(), pyramid.tree_leaves(leaves))
    grads_it = iter(flat)
    grads = pyramid.tree_map(lambda _: next(grads_it), p_l)
    loss = loss.detach()
    warped = warped.detach()

    small = loss < cfg.loss_eps
    plateau = torch.abs(state["loss_prev"] - loss) \
        < state["loss_prev"] * cfg.break_threshold_ratio
    counter = state["counter"] + plateau.to(torch.int32)
    stop = small | (counter >= cfg.max_break_count)
    apply_upd = ~stop

    # manual Adam on the active level's slice
    t_new = state["adam_t"] + 1
    b1t = 1.0 - torch.pow(ADAM_B1, t_new.to(torch.float32))
    b2t = 1.0 - torch.pow(ADAM_B2, t_new.to(torch.float32))
    m_l = _slice_at(state["adam_m"], lvl)
    v_l = _slice_at(state["adam_v"], lvl)
    m2 = pyramid.tree_map(lambda m, g: ADAM_B1 * m + (1 - ADAM_B1) * g,
                          m_l, grads)
    v2 = pyramid.tree_map(lambda v, g: ADAM_B2 * v + (1 - ADAM_B2) * g * g,
                          v_l, grads)
    p2 = pyramid.tree_map(
        lambda p, m, v: torch.where(
            _per_slot(apply_upd, p),
            p - cfg.lr * (m / _per_slot(b1t, m))
            / (torch.sqrt(v / _per_slot(b2t, v)) + ADAM_EPS), p),
        p_l, m2, v2)
    m2 = pyramid.tree_map(lambda new, old: torch.where(
        _per_slot(apply_upd, new), new, old), m2, m_l)
    v2 = pyramid.tree_map(lambda new, old: torch.where(
        _per_slot(apply_upd, new), new, old), v2, v_l)

    it2 = state["it"] + 1
    level_done = stop | (it2 >= cfg.iters)
    is_last = lvl >= pcfg.m - 1
    done2 = level_done & is_last

    # level transition: the next level takes this evaluation's warp;
    # counters reset
    new_state = dict(state)
    new_state.update({
        "params": _put_at(state["params"], lvl, p2),
        "adam_m": _put_at(state["adam_m"], lvl, m2),
        "adam_v": _put_at(state["adam_v"], lvl, v2),
        "adam_t": torch.where(level_done, 0, torch.where(
            apply_upd, t_new, state["adam_t"])),
        "pts": torch.where(level_done[:, None, None], warped, state["pts"]),
        "level": torch.where(level_done & ~is_last, lvl + 1, lvl),
        "loss_prev": torch.where(level_done, 1e6, torch.where(
            stop, state["loss_prev"], loss)),
        "counter": torch.where(level_done, 0, counter),
        "it": torch.where(level_done, 0, it2),
        "done": state["done"] | done2,
        "loss": loss,
        "total_iters": state["total_iters"] + 1,
    })
    # freeze every slot that was done before this step
    frozen = state["done"]
    return pyramid.tree_map(
        lambda new, old: new if new is old
        else torch.where(_per_slot(frozen, new), old, new),
        new_state, state)


def make_stream_fns(cfg: SolverConfig, k_inner: int = 50):
    """The four functions of the stream:

    multi_step(state_B) -> state_B      every slot ``k_inner`` iterations on,
                                        no host read
    refill(state_B, slot, pair_state)   overwrite one slot, in place
    harvest(state_B, slot)              (final full-cloud warp of one slot,
                                        its iterations in all)
    init_one(gen, src, tgt)             one pair's state
    """
    def multi_step(state):
        for _ in range(k_inner):
            state = _pair_step(state, cfg)
        return state

    def refill(state_b, slot: int, pair_state):
        # In place: a state multi_step gave earlier shares its unchanged
        # tensors (the clouds) with the newer one, so the caller reads
        # nothing of an older state's slot after refilling it; on the card
        # the stream orders a harvest enqueued before the refill.
        def put(b, p):
            b[slot] = p
            return b
        return pyramid.tree_map(put, state_b, pair_state)

    def harvest(state_b, slot: int):
        with torch.no_grad():
            params = pyramid.tree_map(lambda a: a[slot], state_b["params"])
            warped, _ = warp(params, state_b["src_c"][slot], cfg.pyramid)
        return warped + state_b["tgt_mean"][slot][None], \
            state_b["total_iters"][slot]

    def init_one(gen, src, tgt):
        return init_pair_state(gen, src, tgt, cfg)

    return multi_step, refill, harvest, init_one


def _fetch_flags(done: Tensor):
    """Start copying the ``done`` flags to the host and return a function
    that waits for them: on the card a copy into pinned memory and an
    event recorded behind it, so the host waits for this step alone and
    not for work enqueued after it."""
    if done.device.type != "cuda":
        flags = done.numpy().copy()
        return lambda: flags
    host = torch.empty(done.shape, dtype=torch.bool, pin_memory=True)
    host.copy_(done, non_blocking=True)
    event = torch.cuda.Event()
    event.record()

    def wait():
        event.synchronize()
        return host.numpy()
    return wait


def register_stream(pairs, cfg: SolverConfig, n_slots: int = 4,
                    k_inner: int = 50, gen: torch.Generator | None = None,
                    device: torch.device | str = "cuda") -> list[Tensor]:
    """Solve a list of (src [N, 3], tgt [M, 3]) pairs (numpy arrays or
    tensors, every pair of the same shapes) with continuous batching on
    ``device``; returns the warped source clouds (tensors on ``device``)
    in input order. ``gen`` (default: seed 0) draws each pair's start in
    input order, as ``register_pair`` called on the pairs one after another
    with that generator would.

    The next ``multi_step`` is enqueued before the older step's ``done``
    flags are read, so the device never idles for the host's round trip:
    a finished slot runs at most one extra, frozen, ``k_inner`` block
    before its refill lands, which changes no result.
    """
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    device = torch.device(device)
    multi_step, refill, harvest, init_one = make_stream_fns(cfg, k_inner)

    def start(i):
        src, tgt = (torch.as_tensor(np.asarray(a, np.float32), device=device)
                    if not isinstance(a, Tensor) else a.to(device)
                    for a in pairs[i])
        return init_one(gen, src, tgt)

    n = len(pairs)
    results: list = [None] * n
    first = [start(i) for i in range(min(n_slots, n))]
    if not first:
        return results
    slot_to_pair = {s: s for s in range(len(first))}
    next_idx = len(first)
    ahead = multi_step(stack_states(first))
    while slot_to_pair:
        pending = _fetch_flags(ahead["done"])
        state_next = multi_step(ahead)              # enqueue ahead
        done_flags = pending()                      # the older step only
        for slot, pair_idx in list(slot_to_pair.items()):
            if not done_flags[slot]:
                continue
            results[pair_idx], _ = harvest(ahead, slot)
            del slot_to_pair[slot]
            if next_idx < n:
                state_next = refill(state_next, slot, start(next_idx))
                slot_to_pair[slot] = next_idx
                next_idx += 1
        ahead = state_next
    return results
