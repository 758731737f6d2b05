"""The standalone level warp as one differentiable op: C2 forward, C3 + C13
backward.

Counterpart of ``deformationpyramid_tpu/ops/fused_level.py``
(``fused_level_warp``, ``fused_level_warp_t``), the opt-in ``use_fused``
route of ``solve/registration.py``, where autograd runs the level loop
and only the warp is a kernel. The JAX package's four kernels are the
forward and the VJP with the forward recomputed, on [N, 3] points
(``_fwd_kernel``, ``_bwd_kernel``) and on [3, N] (``_fwd_kernel_t``,
``_bwd_kernel_t``); the [3, N] layout put N on the TPU's 128 lanes. The port
runs the same kernels for both layouts: **C2** ``level_warp_fwd`` and
**C3** ``level_warp_bwd`` (``csrc/level_warp.cu``), whose per-block partial
gradient rows **C13** ``sum_partials`` (``csrc/adam.cu``) adds up in block
order, as the TPU kernel accumulated them across its sequential grid.
The ``_t`` variant transposes its [3, N] input and output around them.

The points get a zero gradient, as in the JAX package: the solver
optimizes one level on detached points. On CPU tensors every kernel runs
its plain version.
"""
from __future__ import annotations

import torch

from ..models import pyramid
from .fused_iteration import (_supports_warp, level_warp_bwd, level_warp_fwd,
                              sum_partials)

Tensor = torch.Tensor


def supports_fused(cfg: pyramid.NDPConfig) -> bool:
    """The JAX package's gate (SE3 + axis_angle, no nonrigidity head, at
    least one hidden layer... ) with the port's kernel limits: C2 / C3 need
    depth >= 2 where the JAX kernels take depth >= 1, width <= 256 and
    C3's activations within one block's shared memory."""
    return (cfg.motion == "SE3" and cfg.rotation_format == "axis_angle"
            and not cfg.nonrigidity_est and _supports_warp(cfg))


class _FusedLevelWarp(torch.autograd.Function):
    """warped [N, 3] = level warp of x [N, 3] by the flat level vector."""

    @staticmethod
    def forward(ctx, flat: Tensor, x: Tensor, level: int,
                cfg: pyramid.NDPConfig) -> Tensor:
        ctx.save_for_backward(flat, x)
        ctx.level, ctx.cfg = level, cfg
        return level_warp_fwd(flat, x, level, cfg)

    @staticmethod
    def backward(ctx, g: Tensor):
        flat, x = ctx.saved_tensors
        partials = level_warp_bwd(flat, x, g.contiguous(), ctx.level,
                                  ctx.cfg)
        gx = torch.zeros_like(x) if ctx.needs_input_grad[1] else None
        return sum_partials(partials), gx, None, None


def _check(p: dict, cfg: pyramid.NDPConfig) -> Tensor:
    if not supports_fused(cfg):
        raise ValueError("fused_level_warp covers SE3 + axis_angle without "
                         "the nonrigidity head, depth >= 2 (the kernels' "
                         "limit; the JAX kernels take depth >= 1) and "
                         "width <= 256 only")
    return pyramid.ravel(p).to(torch.float32).contiguous()


def fused_level_warp(p: dict, x: Tensor, level: int,
                     cfg: pyramid.NDPConfig) -> Tensor:
    """Drop-in for ``models.pyramid.level_warp`` (warped points only) where
    :func:`supports_fused` holds: ``p`` is one level's parameter dict,
    differentiable through autograd; ``x`` [N, 3] gets a zero gradient."""
    flat = _check(p, cfg)
    return _FusedLevelWarp.apply(flat, x.to(torch.float32).contiguous(),
                                 int(level), cfg)


def fused_level_warp_t(p: dict, xt: Tensor, level: int,
                       cfg: pyramid.NDPConfig) -> Tensor:
    """:func:`fused_level_warp` on [3, N] points, returning [3, N]: the
    JAX package's ``fused_level_warp_t``. The same kernels run on the
    transposed points; the layout was a TPU lane workaround."""
    return fused_level_warp(p, xt.T, level, cfg).T
