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


def run_adam_loop(loss_fn: Callable[[Any, Tensor],
                                    tuple[Tensor, Tensor | None]],
                  params: Any, cfg: LoopConfig, aux_init: Tensor | None = None):
    """Optimize ``params`` (a tree of nested dicts and lists) with Adam
    under the early stop.

    ``loss_fn(params, it) -> (loss, aux)``: ``it`` is the iteration index
    as a 0-d int32 tensor on the parameters' device (the Nerfies baseline
    windows its encoding by it); ``aux`` may be None. Gradients come from
    autograd. Returns (params, aux of the last evaluation, stats {iters,
    loss}). The JAX loop's ``lr_decay`` and per-iteration random key serve
    the embedded-deformation baseline only and are not here.
    """
    shapes = pyramid.tree_map(lambda t: tuple(t.shape), params)
    flat = pyramid.ravel(params).detach().to(torch.float32).clone()
    m = torch.zeros_like(flat)
    v = torch.zeros_like(flat)
    stop = EarlyStop(cfg, flat.device)
    aux = aux_init

    def step():
        nonlocal aux
        f = flat.detach().requires_grad_(True)
        loss, new_aux = loss_fn(pyramid.unravel(f, shapes), stop.it)
        (g,) = torch.autograd.grad(loss, f)
        loss = loss.detach()
        halt, hold = stop.decide(loss)
        adam_step(flat, m, v, g[None], stop.applied,
                  hold.to(torch.float32), cfg.lr)
        stop.advance(loss, halt, hold)
        if new_aux is not None:
            new_aux = new_aux.detach()
            aux = new_aux if aux is None else torch.where(halt, aux, new_aux)

    stop.run(step)
    return pyramid.unravel(flat, shapes), aux, stop.stats()

