"""The fused solver iteration: four kernels and O(N) glue per step.

Counterpart of ``deformationpyramid_tpu/ops/fused_iteration.py``. One
iteration of the level loop is:

* **C2** ``level_warp_fwd`` (``csrc/level_warp.cu``): the level warp of the
  source sample, from the flat parameter vector;
* **C1** ``nn_dual`` (``csrc/nn_dual.cu``, via ``ops/knn.py``): both 1-NN
  directions against the fixed target sample, on the warped points that
  C2 just wrote;
* :func:`_chamfer_glue`: the truncated-L1 chamfer value and its analytic
  gradient with respect to the warped points (O(N) gathers and one
  ``index_add_``);
* **C3** ``level_warp_bwd``: the VJP of the recomputed warp for that
  gradient, one partial parameter gradient per block of points;
* **C4** ``adam_step`` (``csrc/adam.cu``): the partials summed in a fixed
  order and one optax-exact Adam step, in place, held by the device-side
  early-stop flag.

C2 + C1 replace the JAX package's kernel 1 (``_fwd_sweep_kernel``), C3 + C4
its kernel 2 (``_bwd_adam_kernel``). Each kernel's wrapper runs the plain
PyTorch version of the same function when its tensors are on the CPU.

The early-stop state stays on the device as 0-d tensors (:class:`EarlyStop`)
and the host reads it every ``SYNC_EVERY`` iterations only; an iteration
that starts halted changes nothing, so the result is the one of checking
after every iteration. The kernels cover SE3 motion with the axis-angle
rotation, ``w_reg == 0``, no landmarks and depth >= 2 (the reference
``config/NDP.yaml``); every other configuration takes the unfused loop
(``solve/registration.py``).
"""
from __future__ import annotations

import math

import torch

from ..models import pyramid
from .cuda_lib import F, I, Kernel, P, check_cuda, on_cpu
from .knn import nn_argmin_dual

Tensor = torch.Tensor

SYNC_EVERY = 8          # iterations between host reads of the stop flag
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
MAX_WIDTH = 256         # DP_MAX_WIDTH in csrc/common.cuh
BWD_TILE = 32           # BWD_TP in csrc/level_warp.cu: points per C3 block
SMEM_LIMIT = 232448     # shared memory a Hopper block may opt in to
_FLOOR = 1e-16          # sqrt floor, as ops/chamfer._gathered_sum

LEVEL_WARP_FWD = Kernel("level_warp_fwd", "dp_level_warp_fwd",
                        [P, P, I, I, I, F, F, P])
LEVEL_WARP_BWD = Kernel("level_warp_bwd", "dp_level_warp_bwd",
                        [P, P, P, I, I, I, F, F, P, I])
ADAM_STEP = Kernel("adam_step", "dp_adam_step",
                   [P, P, P, P, I, I, P, P, F, F, F, F, F, F])


def supports_fused_iteration(pcfg: pyramid.NDPConfig, w_reg: float,
                             n_ldmk: int = 0) -> bool:
    """What the kernels cover: SE3 + axis_angle, no nonrigidity branch or
    regulariser, no landmarks, at least one hidden layer, width <= 256,
    and C3's activations of every layer within one block's shared memory
    (at width 256, depth <= 5). Narrower than the JAX package's gate
    (which also takes Sim3, sflow, the other rotation formats and
    w_reg > 0)."""
    bwd_smem = 4 * BWD_TILE * (24 + (pcfg.depth + 2) * pcfg.width)
    return (pcfg.motion == "SE3" and pcfg.rotation_format == "axis_angle"
            and not pcfg.nonrigidity_est and w_reg == 0 and n_ldmk == 0
            and pcfg.depth >= 2 and pcfg.width <= MAX_WIDTH
            and bwd_smem <= SMEM_LIMIT)


def level_param_count(pcfg: pyramid.NDPConfig) -> int:
    """Length of one level's flat parameter vector (34,694 at width 128,
    depth 3 with SE3 + axis_angle)."""
    w, nh = pcfg.width, pcfg.depth - 1
    return nh * (w + w * w) + 13 * w + 6


def _freq(level: int, k0: int) -> float:
    return 2.0 ** (level + 1 + k0)


def _plain_warp(flat: Tensor, x: Tensor, level: int,
                pcfg: pyramid.NDPConfig) -> Tensor:
    p = pyramid.unravel(flat, pyramid.level_shapes(pcfg))
    return pyramid.level_warp(p, x, level, pcfg)[0]


def _check_level(name: str, flat: Tensor, x: Tensor,
                 pcfg: pyramid.NDPConfig, *more: Tensor) -> None:
    check_cuda(name, flat, x, *more)
    if not supports_fused_iteration(pcfg, 0.0):
        raise ValueError(f"{name}: the kernel covers SE3 + axis_angle, "
                         f"depth >= 2, width <= {MAX_WIDTH} only")
    if flat.shape != (level_param_count(pcfg),):
        raise ValueError(f"{name}: flat params of shape {tuple(flat.shape)}")
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"{name}: points must be [N, 3]")
    for t in more:
        if t.shape != x.shape:
            raise ValueError(f"{name}: cotangent must be [N, 3]")


def level_warp_fwd(flat: Tensor, x: Tensor, level: int,
                   pcfg: pyramid.NDPConfig) -> Tensor:
    """One level's warp of x [N, 3] from its flat parameter vector: kernel
    C2 on CUDA tensors, ``models.pyramid.level_warp`` on CPU tensors."""
    if on_cpu(flat, x):
        return _plain_warp(flat, x, level, pcfg)
    _check_level("level_warp_fwd", flat, x, pcfg)
    out = torch.empty_like(x)
    LEVEL_WARP_FWD.launch(flat.data_ptr(), x.data_ptr(), x.shape[0],
                          pcfg.width, pcfg.depth, _freq(level, pcfg.k0),
                          float(pcfg.mlp_scale), out.data_ptr())
    return out


def level_warp_bwd_plain(flat: Tensor, x: Tensor, g: Tensor, level: int,
                         pcfg: pyramid.NDPConfig) -> Tensor:
    """``torch.func.vjp`` of the plain warp: the parameter gradient for
    the cotangent g [N, 3], as one partial row [1, P]."""
    _, vjp = torch.func.vjp(lambda f: _plain_warp(f, x, level, pcfg), flat)
    return vjp(g)[0][None]


def level_warp_bwd(flat: Tensor, x: Tensor, g: Tensor, level: int,
                   pcfg: pyramid.NDPConfig) -> Tensor:
    """Parameter gradient of one level's warp for the cotangent g [N, 3],
    as partial rows [n_blocks, P] whose sum is the gradient: kernel C3 on
    CUDA tensors (one row per block of points), the plain VJP on CPU
    tensors (one row)."""
    if on_cpu(flat, x, g):
        return level_warp_bwd_plain(flat, x, g, level, pcfg)
    _check_level("level_warp_bwd", flat, x, pcfg, g)
    n_blocks = -(-x.shape[0] // BWD_TILE)
    partial = torch.empty((n_blocks, flat.shape[0]), dtype=torch.float32,
                          device=flat.device)
    LEVEL_WARP_BWD.launch(flat.data_ptr(), x.data_ptr(), g.data_ptr(),
                          x.shape[0], pcfg.width, pcfg.depth,
                          _freq(level, pcfg.k0), float(pcfg.mlp_scale),
                          partial.data_ptr(), n_blocks)
    return partial


def adam_step_plain(p: Tensor, m: Tensor, v: Tensor, partials: Tensor,
                    applied: Tensor, hold: Tensor, lr: float) -> None:
    """Plain version of kernel C4 (in place): optax.adam's update with bias
    correction by ``applied + 1`` steps, skipped while ``hold > 0.5``."""
    g = partials.sum(0)
    t = applied + 1.0
    bc1 = 1.0 - ADAM_B1 ** t
    bc2 = 1.0 - ADAM_B2 ** t
    m2 = ADAM_B1 * m + (1.0 - ADAM_B1) * g
    v2 = ADAM_B2 * v + (1.0 - ADAM_B2) * (g * g)
    upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + ADAM_EPS) * (-lr)
    keep = hold > 0.5
    p.copy_(torch.where(keep, p, p + upd))
    m.copy_(torch.where(keep, m, m2))
    v.copy_(torch.where(keep, v, v2))


def adam_step(p: Tensor, m: Tensor, v: Tensor, partials: Tensor,
              applied: Tensor, hold: Tensor, lr: float) -> None:
    """One Adam step on the flat vector ``p`` with moments ``m``, ``v``
    (all updated in place) from the gradient ``partials.sum(0)``;
    ``applied`` (steps taken so far) and ``hold`` are f32 0-d tensors on
    the same device. Kernel C4 on CUDA tensors, plain on CPU tensors."""
    if on_cpu(p, m, v, partials, applied, hold):
        adam_step_plain(p, m, v, partials, applied, hold, lr)
        return
    check_cuda("adam_step", p, m, v, partials, applied, hold)
    count = p.shape[0]
    if p.ndim != 1 or m.shape != p.shape or v.shape != p.shape \
            or partials.ndim != 2 or partials.shape[1] != count \
            or applied.numel() != 1 or hold.numel() != 1:
        raise ValueError("adam_step: expected p, m, v [P], partials [B, P] "
                         "and scalar applied/hold")
    ADAM_STEP.launch(p.data_ptr(), m.data_ptr(), v.data_ptr(),
                     partials.data_ptr(), partials.shape[0], count,
                     applied.data_ptr(), hold.data_ptr(),
                     float(lr), ADAM_B1, ADAM_B2, 1.0 - ADAM_B1,
                     1.0 - ADAM_B2, ADAM_EPS)


def _chamfer_glue(w: Tensor, cidx: Tensor, rarg: Tensor, y: Tensor,
                  x_valid: Tensor, y_valid: Tensor, x_len: Tensor,
                  y_len: Tensor, trunc: float) -> tuple[Tensor, Tensor]:
    """Truncated chamfer value and its gradient with respect to the warped
    points w [N, 3], from the sweep's indices (``cidx`` [N] into y,
    ``rarg`` [M] into w). The same value as ``ops.chamfer.truncated_chamfer``
    with its double-where sqrt guard and 1e-16 floor; the target is
    constant."""
    y_nn = y[cidx]
    sq_x = torch.sum((w - y_nn) ** 2, dim=-1)
    keep_x = (sq_x < trunc) & x_valid
    root_x = torch.sqrt(torch.where(keep_x, torch.clamp_min(sq_x, _FLOOR), 1.0))
    loss_x = torch.sum(torch.where(keep_x, root_x, 0.0))

    x_nn = w[rarg]
    sq_y = torch.sum((y - x_nn) ** 2, dim=-1)
    keep_y = (sq_y < trunc) & y_valid
    root_y = torch.sqrt(torch.where(keep_y, torch.clamp_min(sq_y, _FLOOR), 1.0))
    loss_y = torch.sum(torch.where(keep_y, root_y, 0.0))

    loss = loss_x / x_len + loss_y / y_len
    gx = torch.where(keep_x, 1.0 / root_x, 0.0)[:, None] * (w - y_nn) / x_len
    gy = torch.where(keep_y, 1.0 / root_y, 0.0)[:, None] * (x_nn - y) / y_len
    return loss, gx.index_add_(0, rarg, gy)


class EarlyStop:
    """The level loop's 3-way early stop, held on the device.

    1. loss < loss_eps                                   -> stop, no step
    2. |loss_prev - loss| < loss_prev * plateau_ratio    -> counter += 1
    3. counter >= max_break_count                        -> stop, no step

    An iteration that starts halted (``done`` set, or ``it >= iters``)
    changes nothing: not the params, the moments, ``it``, ``loss`` or the
    caller's aux. That makes reading the flag every ``SYNC_EVERY``
    iterations give the same result as reading it after each one.
    """

    def __init__(self, cfg, device: torch.device):
        self.cfg = cfg
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        self.loss = torch.tensor(math.inf, **f32)
        self.loss_prev = torch.tensor(1e6, **f32)
        self.counter = torch.zeros((), **i32)
        self.done = torch.zeros((), dtype=torch.bool, device=device)
        self.it = torch.zeros((), **i32)
        self.applied = torch.zeros((), **f32)

    def decide(self, loss: Tensor) -> tuple[Tensor, Tensor]:
        """Book-keep this iteration's loss; returns (halt, hold): halt = the
        iteration is a no-op, hold = no optimizer step."""
        cfg = self.cfg
        halt = self.done | (self.it >= cfg.iters)
        run = ~halt
        small = loss < cfg.loss_eps
        plateau = torch.abs(self.loss_prev - loss) \
            < self.loss_prev * cfg.break_threshold_ratio
        self.counter = self.counter + (plateau & run).to(torch.int32)
        self.done = torch.where(
            run, small | (self.counter >= cfg.max_break_count), self.done)
        return halt, halt | self.done

    def advance(self, loss: Tensor, halt: Tensor, hold: Tensor) -> None:
        self.loss_prev = torch.where(hold, self.loss_prev, loss)
        self.it = self.it + (~halt).to(torch.int32)
        self.applied = self.applied + (~hold).to(torch.float32)
        self.loss = torch.where(halt, self.loss, loss)

    def run(self, step) -> None:
        """Call ``step`` up to ``iters`` times; read the flag on the host
        every SYNC_EVERY calls and leave once the loop is finished."""
        for i in range(self.cfg.iters):
            step()
            if (i + 1) % SYNC_EVERY == 0 and \
                    bool(self.done | (self.it >= self.cfg.iters)):
                break

    def stats(self) -> dict[str, Tensor]:
        return {"iters": self.it, "loss": self.loss}


def run_fused_level(lvl_params: dict, pts: Tensor, pts_valid: Tensor,
                    t_sample: Tensor, t_valid: Tensor, level: int,
                    pcfg: pyramid.NDPConfig, lcfg, trunc: float = 1e9):
    """Adam-optimize one pyramid level with the fused iteration.

    Drop-in for the unfused level loop (``solve/loop.run_adam_loop`` with
    ``truncated_chamfer``): the same 3-way early stop, the same pre-step
    warped hand-off, the same optax Adam. Returns (updated level params
    dict, warped pts [N, 3] of the last evaluation, stats {iters, loss}).
    """
    if not supports_fused_iteration(pcfg, 0.0):
        raise ValueError("run_fused_level: configuration not covered by the "
                         "kernels; use the unfused loop")
    shapes = pyramid.level_shapes(pcfg)
    p = pyramid.ravel(lvl_params).to(torch.float32).contiguous().clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    x = pts.to(torch.float32).contiguous()
    y = t_sample.to(torch.float32).contiguous()
    xv = pts_valid.to(torch.bool).contiguous()
    yv = t_valid.to(torch.bool).contiguous()
    x_len = torch.clamp_min(xv.sum(), 1).to(torch.float32)
    y_len = torch.clamp_min(yv.sum(), 1).to(torch.float32)
    stop = EarlyStop(lcfg, x.device)
    aux = x.clone()

    def step():
        nonlocal aux
        warped = level_warp_fwd(p, x, level, pcfg)
        _, cidx, _, rarg = nn_argmin_dual(warped, y, xv, yv)
        loss, g = _chamfer_glue(warped, cidx, rarg, y, xv, yv, x_len, y_len,
                                trunc)
        halt, hold = stop.decide(loss)
        partials = level_warp_bwd(p, x, g, level, pcfg)
        adam_step(p, m, v, partials, stop.applied,
                  hold.to(torch.float32), lcfg.lr)
        stop.advance(loss, halt, hold)
        aux = torch.where(halt, aux, warped)

    stop.run(step)
    return pyramid.unravel(p, shapes), aux, stop.stats()
