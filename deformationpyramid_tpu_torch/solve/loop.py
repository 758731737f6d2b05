"""Adam with the 3-way early stop, for any loss over a parameter dict.

Counterpart of ``deformationpyramid_tpu/solve/loop.py``:

  1. loss < loss_eps                                   -> stop, no step
  2. |loss_prev - loss| < loss_prev * plateau_ratio    -> counter += 1
  3. counter >= max_break_count                        -> stop, no step

The parameter dict is flattened into one vector in sorted-key order (the
layout of JAX's ``ravel_pytree``) and Adam is the hand-written optax-exact
step of ``ops/fused_iteration.adam_step`` (kernel C4 on the card). The
early-stop state stays on the device (``ops/fused_iteration.EarlyStop``);
the host reads it every few iterations only. The aux output of the last
evaluation (e.g. the warped points before the final step) is kept, as the
reference hands it to the next stage.

``lr_decay`` is optax's ``exponential_decay(lr, transition_steps=1,
decay_rate=g)``: the k-th applied update (k = 0, 1, ...) uses lr * g^k, and
a held step does not advance k. Every step before the stop is applied and
none after it, so the host's count of steps is k wherever the rate is used:
the rate goes to kernel C4 as a host float, and with no decay C4 receives
``lr`` unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..models import pyramid
from ..ops.fused_iteration import EarlyStop, adam_step

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    iters: int = 500
    lr: float = 0.01
    max_break_count: int = 15
    break_threshold_ratio: float = 0.001
    loss_eps: float = 1e-4
    lr_decay: float | None = None  # per-step exponential gamma (ED: 0.999)


def run_adam_loop(loss_fn: Callable[..., tuple[Tensor, Tensor | None]],
                  params: Any, cfg: LoopConfig, aux_init: Tensor | None = None,
                  gen: torch.Generator | None = None):
    """Optimize ``params`` (a tree of nested dicts and lists) with Adam
    under the early stop.

    ``loss_fn(params, it) -> (loss, aux)``: ``it`` is the iteration index
    as a 0-d int32 tensor on the parameters' device (the Nerfies baseline
    windows its encoding by it); ``aux`` may be None. With ``gen`` (a
    ``torch.Generator``, best on the parameters' device, so that the draws
    stay there) the call is ``loss_fn(params, it, gen)``: the random stream
    that the JAX loop splits a key from every iteration, for solvers that
    resample their points each step (the ED baseline,
    ``registration.py:381-390``). Gradients come from autograd. Returns
    (params, aux of the last evaluation, stats {iters, loss}).
    """
    shapes = pyramid.tree_map(lambda t: tuple(t.shape), params)
    flat = pyramid.ravel(params).detach().to(torch.float32).clone()
    m = torch.zeros_like(flat)
    v = torch.zeros_like(flat)
    stop = EarlyStop(cfg, flat.device)
    aux = aux_init
    k = 0   # steps taken: the applied updates' count wherever one applies

    def step():
        nonlocal aux, k
        f = flat.detach().requires_grad_(True)
        extra = () if gen is None else (gen,)
        loss, new_aux = loss_fn(pyramid.unravel(f, shapes), stop.it, *extra)
        (g,) = torch.autograd.grad(loss, f)
        loss = loss.detach()
        halt, hold = stop.decide(loss)
        lr = cfg.lr if cfg.lr_decay is None else cfg.lr * cfg.lr_decay ** k
        adam_step(flat, m, v, g[None], stop.applied,
                  hold.to(torch.float32), lr)
        stop.advance(loss, halt, hold)
        k += 1
        if new_aux is not None:
            new_aux = new_aux.detach()
            aux = new_aux if aux is None else torch.where(halt, aux, new_aux)

    stop.run(step)
    return pyramid.unravel(flat, shapes), aux, stop.stats()

