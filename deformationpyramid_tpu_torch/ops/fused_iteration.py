"""The fused solver iteration: hand-written kernels and O(N) glue per step.

Counterpart of ``deformationpyramid_tpu/ops/fused_iteration.py``. One
iteration of the chamfer-mode level loop is:

* **C2** ``level_warp_fwd`` (``csrc/level_warp.cu``): the level warp of the
  source sample, from the flat parameter vector (C3's forward: its
  width x width products as 3xTF32 on the tensor cores, a tile of
  :func:`fwd_tile` points a block);
* **C1** ``nn_dual`` (``csrc/nn_dual.cu``, via ``ops/knn.py``): both 1-NN
  directions against the fixed target sample, on the warped points that
  C2 just wrote;
* :func:`_chamfer_glue`: the truncated-L1 chamfer value and its analytic
  gradient with respect to the warped points (O(N) gathers and the y->x
  scatter, kernel **C6** ``scatter_rows``, whose summation order is
  fixed), plus the masked landmark term in landmark + chamfer mode;
* **C3** ``level_warp_bwd``: the VJP of the recomputed warp for that
  gradient, one partial parameter gradient per block of points (its
  width x width products as 3xTF32 on the tensor cores, a tile of
  :func:`bwd_tile` points a block);
* **C4** ``adam_step`` (``csrc/adam.cu``): the partials summed in a fixed
  order and one optax-exact Adam step, in place, held by the device-side
  early-stop flag.

C2 + C1 replace the JAX package's kernel 1 (``_fwd_sweep_kernel``), C3 + C4
its kernel 2 (``_bwd_adam_kernel``). The landmark-only loop (LNDP with
``w_cd == 0``) runs one launch per iteration instead: **C5**
``ldmk_iteration`` (``csrc/ldmk_iteration.cu``) replaces
``_ldmk_iter_kernel`` (:func:`run_fused_level_ldmk`). The NSFP baseline's
loop (:func:`run_fused_nsfp`) is the chamfer-mode iteration with the
flow-field MLP in place of the level: **C10** ``nsfp_fwd`` and **C11**
``nsfp_bwd`` (``csrc/nsfp.cu``: C3's tensor-core tile for the hidden
layers, tiles of :func:`nsfp_fwd_tile` / :func:`nsfp_bwd_tile` points)
replace kernels 1 and 2 with ``model="nsfp"``, around the same C1, glue,
C6 and C4. Each kernel's wrapper runs the plain PyTorch version of the
same function when its tensors are on the CPU.

The early-stop state stays on the device as 0-d tensors (:class:`EarlyStop`)
and the host reads it every ``SYNC_EVERY`` iterations only; an iteration
that starts halted changes nothing, so the result is the one of checking
after every iteration. The level kernels cover every ``motion_type`` and
``rotation_format`` of ``config/NDP.yaml`` (SE3, Sim3, sflow; axis_angle,
euler, quaternion, 6D) and the nonrigidity head (``w_reg > 0``: C2 writes
the head's output beside the warped points, the glue adds the BCE term in
plain torch as the JAX package adds it in XLA, C3 takes its cotangent), at
depth >= 2. One iteration is one function (:func:`_level_step`), and a
chamfer-mode level runs it one of two ways: on the card, for a shape seen
before, as replays of one captured CUDA graph of ``SYNC_EVERY`` iterations
between reads of the flag (:class:`LevelGraphs`), one host launch where the
eager loop makes ~81; otherwise in the eager loop (:meth:`EarlyStop.run`).
"""
from __future__ import annotations

import collections
import math
import threading
import warnings

import torch

from ..losses import bce_with_zeros_target
from ..models import baselines, pyramid
from ..utils import timers
from . import cuda_lib
from .cuda_lib import F, I, Kernel, P, check_cuda, on_cpu
from .knn import nn_argmin_dual

Tensor = torch.Tensor

SYNC_EVERY = 8          # iterations between host reads of the stop flag
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
MAX_WIDTH = 256         # DP_MAX_WIDTH in csrc/common.cuh
BWD_TILE = 16           # C3_MT in csrc/level_tile_tc.cuh: a block of C2,
                        # C3, C5, C10 or C11 takes a multiple of these
                        # points (fwd_tile, bwd_tile, ...)
C3_MAX_BLOCKS = 132     # C2 / C3 grids of at most one block for each SM of
                        # an H100
LDMK_MAX_ROWS = 1 << 24  # LDMK_MAX_ROWS in csrc/ldmk_iteration.cu: the
                         # landmark rows one C5 launch takes
LDMK_STATIC_SMEM = 128  # LDMK_STATIC_SMEM there: C5's static shared memory
SMEM_LIMIT = 232448     # shared memory a Hopper block may opt in to
_FLOOR = 1e-16          # sqrt floor, as ops/chamfer._gathered_sum

# Codes of csrc/common.cuh DpMotion and DpRotFmt.
MOTIONS = {"SE3": 0, "Sim3": 1, "sflow": 2}
ROTATION_FORMATS = {"axis_angle": 0, "euler": 1, "quaternion": 2, "6D": 3}

LEVEL_WARP_FWD = Kernel("level_warp_fwd", "dp_level_warp_fwd",
                        [P, P, I, I, I, I, I, I, I, F, F, P, P, I])
LEVEL_WARP_BWD = Kernel("level_warp_bwd", "dp_level_warp_bwd",
                        [P, P, P, P, I, I, I, I, I, I, I, F, F, P, I, I])
ADAM_STEP = Kernel("adam_step", "dp_adam_step",
                   [P, P, P, P, I, I, P, P, F, F, F, F, F, F])
SUM_PARTIALS = Kernel("sum_partials", "dp_sum_partials", [P, I, I, P])
LDMK_ITERATION = Kernel(
    "ldmk_iteration", "dp_ldmk_iteration",
    [P, P, P, P, P, P, I, I, I, I, I, F, F, P, P, P, P, P, P, P, I, I, F, F,
     F, F, F, F, F, F, P, P, P, P, I, I])
SCATTER_ROWS = Kernel("scatter_rows", "dp_scatter_rows", [P, I, P, P, I])
NSFP_FWD = Kernel("nsfp_fwd", "dp_nsfp_fwd", [P, P, I, I, I, P, I])
NSFP_BWD = Kernel("nsfp_bwd", "dp_nsfp_bwd", [P, P, P, I, I, I, P, I, I, P])


def _head_slots(pcfg: pyramid.NDPConfig) -> int:
    """Head outputs per point in the kernels (csrc/common.cuh LevelLayout
    ``hs``): rotation (none for sflow), translation, the Sim3 scale and
    the nonrigidity head; 3 for sflow up to 11 for Sim3 + 6D with the
    nonrigidity head."""
    rot = 0 if pcfg.motion == "sflow" else pcfg.rot_dim
    return rot + 3 + (pcfg.motion == "Sim3") + bool(pcfg.nonrigidity_est)


def bwd_smem(pcfg: pyramid.NDPConfig) -> int:
    """The shared-memory measure of what the level kernels cover, in bytes:
    every layer's activations of 32 points plus the gradient buffers, with
    the nonrigidity head's cotangent, as the kernels' first tile (FMA, one
    thread a hidden unit) held them. The gate keeps that coverage; C3's
    tile at 16 points (:func:`c3_smem`, and C5's, :func:`ldmk_smem`) needs
    less, so every covered configuration fits it."""
    hs = _head_slots(pcfg)
    return 4 * 32 * (12 + bool(pcfg.nonrigidity_est) + 2 * hs
                     + (pcfg.depth + 2) * pcfg.width)


def row_floats(width: int) -> int:
    """Floats of one row of C3's tile buffers (csrc/level_tile_tc.cuh
    ``c3_ld``): the width rounded up to 16 and then to 8 (mod 32)."""
    wp = -(-width // 16) * 16
    return wp + (40 - wp % 32) % 32


def c3_smem(pcfg: pyramid.NDPConfig, tile: int) -> int:
    """Shared memory of one C3 block of ``tile`` points in bytes
    (csrc/level_tile_tc.cuh ``c3_smem_floats``): every layer's activations
    and two gradient buffers as rows of :func:`row_floats`, and the points'
    inputs, features and heads."""
    return 4 * tile * ((pcfg.depth + 2) * row_floats(pcfg.width) + 12
                       + 2 * _head_slots(pcfg) + bool(pcfg.nonrigidity_est))


def ldmk_smem(pcfg: pyramid.NDPConfig, tile: int) -> int:
    """Shared memory of one C5 block of ``tile`` rows in bytes: C3's tile
    (:func:`c3_smem`; C5 has no nonrigidity head) and the kernel's static
    shared memory."""
    return c3_smem(pcfg, tile) + LDMK_STATIC_SMEM


def c2_smem(pcfg: pyramid.NDPConfig, tile: int) -> int:
    """Shared memory of one C2 block of ``tile`` points in bytes
    (csrc/level_tile_tc.cuh ``c2_smem_floats``): two activation buffers
    with C3's rows, and the points, features and heads."""
    return 4 * tile * (2 * row_floats(pcfg.width) + 9 + _head_slots(pcfg))


def _one_wave_tile(n: int, smem, cfg) -> int:
    """Whole m-tiles of ``BWD_TILE`` points, as few a block as keep the
    grid within ``C3_MAX_BLOCKS``, fewer where ``smem(cfg, tile)`` bytes
    would not fit a block (never below one m-tile)."""
    m_tiles = max(-(-n // BWD_TILE), 1)
    tile = BWD_TILE * -(-m_tiles // C3_MAX_BLOCKS)
    while tile > BWD_TILE and smem(cfg, tile) > SMEM_LIMIT:
        tile -= BWD_TILE
    return tile


def bwd_tile(n: int, pcfg: pyramid.NDPConfig) -> int:
    """Points per C3 block for n points: whole m-tiles of ``BWD_TILE``,
    as few a block as keep the grid within ``C3_MAX_BLOCKS`` (one block an
    SM; 2000 points: 125 blocks of 16, 6000: 125 of 48), fewer where a
    block's shared memory would not fit. C3 writes ``-(-n // tile)``
    partial rows."""
    return _one_wave_tile(n, c3_smem, pcfg)


def fwd_tile(n: int, pcfg: pyramid.NDPConfig) -> int:
    """Points per C2 block for n points: C3's one-wave rule
    (:func:`bwd_tile`) with C2's shared memory (:func:`c2_smem`). The warp
    of a point does not depend on its tile."""
    return _one_wave_tile(n, c2_smem, pcfg)


def ldmk_tile(n: int, pcfg: pyramid.NDPConfig) -> int:
    """Rows per C5 tile for n landmark rows: C3's one-wave rule
    (:func:`bwd_tile`) with C5's shared memory (:func:`ldmk_smem`; 2048
    rows: 128 tiles of 16, 4096: 128 of 32). Where the card holds fewer
    blocks than tiles, each block loops over its tiles
    (csrc/ldmk_iteration.cu)."""
    return _one_wave_tile(n, ldmk_smem, pcfg)


def _supports_warp(pcfg: pyramid.NDPConfig) -> bool:
    """What C2 / C3 cover: every motion and rotation format, with or
    without the nonrigidity head, at least one hidden layer (the JAX
    kernels take depth >= 1), width <= 256, and every layer's activations
    of a 32-row tile within one block's shared memory (:func:`bwd_smem`)."""
    return (pcfg.motion in MOTIONS
            and pcfg.rotation_format in ROTATION_FORMATS
            and pcfg.depth >= 2 and pcfg.width <= MAX_WIDTH
            and bwd_smem(pcfg) <= SMEM_LIMIT)


def supports_fused_iteration(pcfg: pyramid.NDPConfig, w_reg: float,
                             n_ldmk: int = 0) -> bool:
    """What the chamfer-mode kernels cover, the JAX package's gate: every
    motion (SE3, Sim3, sflow) and rotation format (axis_angle, euler,
    quaternion, 6D), the nonrigidity head and its BCE term (``w_reg > 0``
    needs ``nonrigidity_est``, which ``solver_from_config`` sets from
    ``w_reg``), no landmarks; and, the port's own limits, at least one
    hidden layer, width <= 256 and every layer's activations of a 32-row
    tile within one block's shared memory (at width 256, depth <= 5 for
    SE3)."""
    return (_supports_warp(pcfg) and n_ldmk == 0
            and (w_reg == 0 or pcfg.nonrigidity_est))


def supports_fused_iteration_ldmk(pcfg: pyramid.NDPConfig, w_reg: float,
                                  n_ldmk: int) -> bool:
    """What the landmark paths cover (``config/LNDP.yaml``, ``w_reg ==
    0``, no nonrigidity head: C5 has none, as ``_ldmk_iter_kernel``): with
    ``w_cd == 0`` the one-launch iteration C5 (:func:`run_fused_level_ldmk`),
    with ``w_cd > 0`` C1-C4 with the landmark term in the glue
    (``run_fused_level(n_ldmk=...)``). The same warp coverage as
    :func:`supports_fused_iteration`, and at most ``LDMK_MAX_ROWS``
    landmark rows (C5's limit: its blocks loop over their tiles where the
    card does not hold one block a tile)."""
    return (_supports_warp(pcfg) and not pcfg.nonrigidity_est
            and w_reg == 0 and 0 < n_ldmk <= LDMK_MAX_ROWS)


def level_param_count(pcfg: pyramid.NDPConfig) -> int:
    """Length of one level's flat parameter vector (34,694 at width 128,
    depth 3 with SE3 + axis_angle; every further head output adds
    width + 1)."""
    w, nh = pcfg.width, pcfg.depth - 1
    return nh * (w + w * w) + 7 * w + _head_slots(pcfg) * (w + 1)


def _freq(level: int, k0: int) -> float:
    return 2.0 ** (level + 1 + k0)


def _layout_args(pcfg: pyramid.NDPConfig) -> tuple[int, int, int, int]:
    return (pcfg.width, pcfg.depth, MOTIONS[pcfg.motion],
            ROTATION_FORMATS[pcfg.rotation_format])


def _plain_warp_nr(flat: Tensor, x: Tensor, level: int,
                   pcfg: pyramid.NDPConfig) -> tuple[Tensor, Tensor | None]:
    p = pyramid.unravel(flat, pyramid.level_shapes(pcfg))
    return pyramid.level_warp(p, x, level, pcfg)


def _plain_warp(flat: Tensor, x: Tensor, level: int,
                pcfg: pyramid.NDPConfig) -> Tensor:
    return _plain_warp_nr(flat, x, level, pcfg)[0]


def _check_level(name: str, flat: Tensor, x: Tensor,
                 pcfg: pyramid.NDPConfig, *more: Tensor) -> None:
    check_cuda(name, flat, x, *more)
    if not _supports_warp(pcfg):
        raise ValueError(f"{name}: the kernel covers depth >= 2, width <= "
                         f"{MAX_WIDTH} and its shared memory only")
    if flat.shape != (level_param_count(pcfg),):
        raise ValueError(f"{name}: flat params of shape {tuple(flat.shape)}")
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"{name}: points must be [N, 3]")
    for t in more:
        if t.shape != x.shape:
            raise ValueError(f"{name}: cotangent must be [N, 3]")


def _warp_launch(flat: Tensor, x: Tensor, level: int,
                 pcfg: pyramid.NDPConfig) -> tuple[Tensor, Tensor | None]:
    """Kernel C2 on CUDA tensors: (warped [N, 3], nonrigidity [N] or
    None)."""
    _check_level("level_warp_fwd", flat, x, pcfg)
    out = torch.empty_like(x)
    nr = torch.empty(x.shape[0], dtype=torch.float32, device=x.device) \
        if pcfg.nonrigidity_est else None
    LEVEL_WARP_FWD.launch(flat.data_ptr(), x.data_ptr(), x.shape[0],
                          *_layout_args(pcfg), int(pcfg.nonrigidity_est),
                          int(level > 0), _freq(level, pcfg.k0),
                          float(pcfg.mlp_scale), out.data_ptr(),
                          0 if nr is None else nr.data_ptr(),
                          fwd_tile(x.shape[0], pcfg))
    return out, nr


def level_warp_fwd(flat: Tensor, x: Tensor, level: int,
                   pcfg: pyramid.NDPConfig) -> Tensor:
    """One level's warp of x [N, 3] from its flat parameter vector: kernel
    C2 on CUDA tensors, ``models.pyramid.level_warp`` on CPU tensors."""
    if on_cpu(flat, x):
        return _plain_warp(flat, x, level, pcfg)
    return _warp_launch(flat, x, level, pcfg)[0]


def level_warp_fwd_nr(flat: Tensor, x: Tensor, level: int,
                      pcfg: pyramid.NDPConfig) -> tuple[Tensor, Tensor]:
    """The warp with the nonrigidity head (``pcfg.nonrigidity_est``):
    (warped [N, 3], nonrigidity [N]), the gate of ``level_warp`` applied
    at level > 0 and all ones at level 0. Kernel C2 on CUDA tensors."""
    if not pcfg.nonrigidity_est:
        raise ValueError("level_warp_fwd_nr: the configuration has no "
                         "nonrigidity head")
    if on_cpu(flat, x):
        return _plain_warp_nr(flat, x, level, pcfg)
    return _warp_launch(flat, x, level, pcfg)


def level_warp_bwd_plain(flat: Tensor, x: Tensor, g: Tensor, level: int,
                         pcfg: pyramid.NDPConfig,
                         g_nr: Tensor | None = None) -> Tensor:
    """``torch.func.vjp`` of the plain warp: the parameter gradient for
    the cotangent g [N, 3] (and g_nr [N] of the nonrigidity with the
    head), as one partial row [1, P]."""
    if not pcfg.nonrigidity_est:
        _, vjp = torch.func.vjp(lambda f: _plain_warp(f, x, level, pcfg),
                                flat)
        return vjp(g)[0][None]
    _, vjp = torch.func.vjp(lambda f: _plain_warp_nr(f, x, level, pcfg),
                            flat)
    if g_nr is None:
        g_nr = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    return vjp((g, g_nr))[0][None]


def level_warp_bwd(flat: Tensor, x: Tensor, g: Tensor, level: int,
                   pcfg: pyramid.NDPConfig,
                   g_nr: Tensor | None = None) -> Tensor:
    """Parameter gradient of one level's warp for the cotangent g [N, 3]
    (and, with the nonrigidity head, g_nr [N] of its output; zero when
    None), as partial rows [n_blocks, P] whose sum is the gradient: kernel
    C3 on CUDA tensors (one row per block of :func:`bwd_tile` points), the
    plain VJP on CPU tensors (one row)."""
    if on_cpu(flat, x, g):
        return level_warp_bwd_plain(flat, x, g, level, pcfg, g_nr)
    _check_level("level_warp_bwd", flat, x, pcfg, g)
    nonrigid = bool(pcfg.nonrigidity_est)
    if nonrigid:
        if g_nr is None:
            g_nr = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        check_cuda("level_warp_bwd", g_nr)
        if g_nr.shape != (x.shape[0],):
            raise ValueError("level_warp_bwd: g_nr must be [N]")
    tile = bwd_tile(x.shape[0], pcfg)
    n_blocks = -(-x.shape[0] // tile)
    partial = torch.empty((n_blocks, flat.shape[0]), dtype=torch.float32,
                          device=flat.device)
    LEVEL_WARP_BWD.launch(flat.data_ptr(), x.data_ptr(), g.data_ptr(),
                          g_nr.data_ptr() if nonrigid else 0, x.shape[0],
                          *_layout_args(pcfg), int(nonrigid), int(level > 0),
                          _freq(level, pcfg.k0), float(pcfg.mlp_scale),
                          partial.data_ptr(), n_blocks, tile)
    return partial


def sum_partials(partials: Tensor) -> Tensor:
    """The gradient [P] from C3's partial rows [B, P], summed in block
    order: kernel C13 (``csrc/adam.cu``) on CUDA tensors, whose sum is
    C4's and repeats bit for bit; ``partials.sum(0)`` on CPU tensors."""
    if on_cpu(partials):
        return partials.sum(0)
    check_cuda("sum_partials", partials)
    if partials.ndim != 2:
        raise ValueError("sum_partials: expected partials [B, P]")
    out = torch.empty(partials.shape[1], dtype=torch.float32,
                      device=partials.device)
    SUM_PARTIALS.launch(partials.data_ptr(), partials.shape[0],
                        partials.shape[1], out.data_ptr())
    return out


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


def scatter_add_rows(dst: Tensor, idx: Tensor, src: Tensor) -> Tensor:
    """``dst[idx[j]] += src[j]`` in place for rows dst [N, 3], src [M, 3],
    idx [M] (int64, in [0, N)), each row's additions in increasing j.

    Kernel C6 ``scatter_rows`` (``csrc/scatter_rows.cu``) on CUDA tensors,
    whose sums are bit-equal to ``index_add_`` on the CPU, its plain
    version; ``index_add_`` on CUDA adds with float atomics in an order
    that changes from run to run."""
    if on_cpu(dst, idx, src):
        return dst.index_add_(0, idx, src)
    check_cuda("scatter_rows", dst, src)
    check_cuda("scatter_rows", idx, dtype=torch.int64)
    n, m = dst.shape[0], src.shape[0]
    if dst.shape != (n, 3) or src.shape != (m, 3) or idx.shape != (m,):
        raise ValueError("scatter_rows: expected dst [N, 3], src [M, 3] and "
                         "idx [M]")
    if n and m:
        SCATTER_ROWS.launch(dst.data_ptr(), n, idx.data_ptr(), src.data_ptr(),
                            m)
    return dst


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
    return loss, scatter_add_rows(gx, rarg, gy)


class EarlyStop:
    """The level loop's 3-way early stop, held on the device.

    1. loss < loss_eps                                   -> stop, no step
    2. |loss_prev - loss| < loss_prev * plateau_ratio    -> counter += 1
    3. counter >= max_break_count                        -> stop, no step

    An iteration that starts halted (``done`` set, or ``it >= iters``)
    changes nothing: not the params, the moments, ``it``, ``loss`` or the
    caller's aux. That makes reading the flag every ``SYNC_EVERY``
    iterations give the same result as reading it after each one.

    Every state tensor is updated in place and keeps its identity for the
    object's life (C4 and C5 read them through pointers, and a captured
    CUDA graph of the loop reads on each replay what the last one wrote).
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

    def reset(self) -> None:
        """Back to the state of a new loop, in place."""
        self.loss.fill_(math.inf)
        self.loss_prev.fill_(1e6)
        for t in (self.counter, self.done, self.it, self.applied):
            t.zero_()

    def decide(self, loss: Tensor) -> tuple[Tensor, Tensor]:
        """Book-keep this iteration's loss; returns (halt, hold): halt = the
        iteration is a no-op, hold = no optimizer step."""
        cfg = self.cfg
        halt = self.done | (self.it >= cfg.iters)
        run = ~halt
        small = loss < cfg.loss_eps
        plateau = torch.abs(self.loss_prev - loss) \
            < self.loss_prev * cfg.break_threshold_ratio
        self.counter.add_((plateau & run).to(torch.int32))
        torch.where(run, small | (self.counter >= cfg.max_break_count),
                    self.done, out=self.done)
        return halt, halt | self.done

    def advance(self, loss: Tensor, halt: Tensor, hold: Tensor) -> None:
        torch.where(hold, self.loss_prev, loss, out=self.loss_prev)
        self.it.add_((~halt).to(torch.int32))
        self.applied.add_((~hold).to(torch.float32))
        torch.where(halt, self.loss, loss, out=self.loss)

    def finished(self) -> bool:
        """The host read of the stop flag (a device synchronisation)."""
        return bool(self.done | (self.it >= self.cfg.iters))

    def run(self, step) -> int:
        """Call ``step`` up to ``iters`` times; read the flag on the host
        every SYNC_EVERY calls and leave once the loop is finished.
        Returns the calls issued."""
        issued = 0
        for issued in range(1, self.cfg.iters + 1):
            step()
            if issued % SYNC_EVERY == 0 and self.finished():
                break
        self.count_noops(issued)
        return issued

    def count_noops(self, issued: int) -> None:
        """While the profiler records, add the calls of the loop's step
        that applied nothing (those after the stop, until the host read
        the flag) to the counter ``early_stop.noops``: ``issued`` less
        ``it``. The read of ``it`` is a host read, made once the loop has
        left, where the read of the flag has as a rule drained the device
        already."""
        if timers.recording():
            timers.count("early_stop.noops", issued - int(self.it))

    def stats(self) -> dict[str, Tensor]:
        return {"iters": self.it, "loss": self.loss}


GRAPH_CACHE_SIZE = 32   # level shapes a LevelGraphs keeps (seen, or a graph)
_FAILED = object()      # LevelGraphs' mark of a key whose capture failed


def level_graph_key(device: torch.device, n: int, m: int, level: int,
                    pcfg: pyramid.NDPConfig, lcfg, trunc: float,
                    n_ldmk: int, w_cd: float, w_eff: float) -> tuple:
    """What a captured block of a chamfer-mode level bakes in: the device,
    the source and target rows, the level (C2 / C3 take its frequency and
    its gate as launch arguments), the pyramid, the loop's settings, the
    truncation, the landmark rows and the two weights."""
    return (device, n, m, level, pcfg,
            (lcfg.iters, lcfg.lr, lcfg.loss_eps, lcfg.break_threshold_ratio,
             lcfg.max_break_count),
            float(trunc), n_ldmk, float(w_cd), float(w_eff))


class LevelGraphs:
    """Which chamfer-mode level loops replay a captured CUDA graph.

    A key (:func:`level_graph_key`) seen for the first time runs the eager
    loop and is remembered: a shape seen once never pays for a capture,
    and the eager loop has built the kernels, set their shared memory and
    settled the allocator before a capture. The key's second sight
    captures a block of ``SYNC_EVERY`` iterations (:class:`_LevelGraph`),
    and every later sight replays it. A key whose capture failed stays
    eager. At most ``size`` keys are kept, the least recently used dropped
    first, its graph and buffers with it. The graphs share one memory
    pool: one level's replays never overlap another's, and no tensor a
    graph allocates outlives its capture. ``lock`` is held while a graph's
    buffers are in use; a second thread runs the eager loop.
    """

    EAGER, CAPTURE, REPLAY = "eager", "capture", "replay"

    def __init__(self, size: int = GRAPH_CACHE_SIZE):
        self.size = size
        self.lock = threading.Lock()
        self._keys: collections.OrderedDict = collections.OrderedDict()
        self._pool = None

    def plan(self, key) -> tuple[str, "_LevelGraph | None"]:
        """What a level of ``key`` runs, and marks the key the most
        recently used: (EAGER, None) at its first sight or after a failed
        capture, (CAPTURE, None) at its second, (REPLAY, graph) after."""
        if key not in self._keys:
            self._keys[key] = None
            if len(self._keys) > self.size:
                self._keys.popitem(last=False)
            return self.EAGER, None
        self._keys.move_to_end(key)
        got = self._keys[key]
        if got is None:
            return self.CAPTURE, None
        if got is _FAILED:
            return self.EAGER, None
        return self.REPLAY, got

    def store(self, key, graph: "_LevelGraph | None") -> None:
        """The captured graph of ``key``; None where its capture failed."""
        self._keys[key] = _FAILED if graph is None else graph

    def pool(self):
        """The graphs' memory pool (one id serves every device)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool


_GRAPHS = LevelGraphs()


class _LevelGraph:
    """A level shape's captured block of ``SYNC_EVERY`` exact iterations
    and the tensors it reads and writes: the loop's (:func:`_level_tensors`,
    aux among them) and the early-stop state. Capture records and runs
    nothing, so the first replay starts from the state as loaded, and a
    kernel's ``launches`` counts the block's launches (``launches``) at
    each replay, not at the capture."""

    def __init__(self, tensors: dict[str, Tensor], stop: EarlyStop, step,
                 pool):
        self.tensors, self.stop = tensors, stop
        before = [k.launches for k in cuda_lib.KERNELS]
        try:
            self.graph = _record(step, pool)
        finally:
            self.launches = [(k, k.launches - n) for k, n in
                             zip(cuda_lib.KERNELS, before) if k.launches != n]
            for k, n in self.launches:
                k.launches -= n

    def load(self, fresh: dict[str, Tensor]) -> None:
        """A new level's tensors into the graph's, and a new loop."""
        for k, t in fresh.items():
            self.tensors[k].copy_(t)
        self.stop.reset()

    def run(self) -> int:
        """Replay until the host reads the loop finished, at most
        ceil(iters / SYNC_EVERY) times: a block's iterations past the stop
        or the cap are no-ops. Returns the replays."""
        replays = 0
        for replays in range(1, -(-self.stop.cfg.iters // SYNC_EVERY) + 1):
            self.graph.replay()
            for k, n in self.launches:
                k.launches += n
            if self.stop.finished():
                break
        return replays


def _record(step, pool) -> torch.cuda.CUDAGraph:
    """``SYNC_EVERY`` calls of ``step`` captured as one CUDA graph, its
    temporaries in the memory pool ``pool``; a failed capture raises
    ``RuntimeError``."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool,
                          capture_error_mode="thread_local"):
        for _ in range(SYNC_EVERY):
            step()
    return graph


def _level_tensors(lvl_params: dict, pts: Tensor, pts_valid: Tensor,
                   t_sample: Tensor, t_valid: Tensor, n_ldmk: int,
                   tgt_ldmk: Tensor | None, ldmk_valid: Tensor | None,
                   pcfg: pyramid.NDPConfig) -> dict[str, Tensor]:
    """The tensors a chamfer-mode level loop starts from: the flat params
    ``p`` and Adam's moments, the points, their masks and counts, the
    landmark term's (``n_ldmk > 0``), zeros for the nonrigidity cotangent
    (with the head), and ``aux``, the warped points handed on."""
    p = pyramid.ravel(lvl_params).to(torch.float32).contiguous().clone()
    x = pts.to(torch.float32).contiguous()
    n = x.shape[0]
    rows = torch.arange(n, device=x.device)
    row_valid = pts_valid.to(torch.bool)
    xv = (row_valid & (rows >= n_ldmk)).contiguous()
    yv = t_valid.to(torch.bool).contiguous()
    t = dict(p=p, m=torch.zeros_like(p), v=torch.zeros_like(p), x=x,
             y=t_sample.to(torch.float32).contiguous(), row_valid=row_valid,
             xv=xv, yv=yv,
             x_len=torch.clamp_min(xv.sum(), 1).to(torch.float32),
             y_len=torch.clamp_min(yv.sum(), 1).to(torch.float32),
             aux=x.clone())
    if n_ldmk > 0:
        lmask = torch.zeros(n, dtype=torch.float32, device=x.device)
        lmask[:n_ldmk] = ldmk_valid.to(torch.float32)
        ltgt = torch.zeros_like(x)
        ltgt[:n_ldmk] = tgt_ldmk.to(torch.float32)
        t.update(lmask=lmask, lcount=torch.clamp_min(lmask.sum(), 1.0),
                 ltgt=ltgt)
    if pcfg.nonrigidity_est:
        t["zeros_nr"] = torch.zeros(n, dtype=torch.float32, device=x.device)
    return t


def _level_step(t: dict[str, Tensor], stop: EarlyStop, level: int,
                pcfg: pyramid.NDPConfig, lcfg, trunc: float, n_ldmk: int,
                w_cd: float, w_eff: float):
    """One exact chamfer-mode iteration on the tensors ``t`` and ``stop``,
    every result written in place: the warp (C2, with the head's output
    where it has one), the sweep (C1), the glue with C6 and the landmark
    term, the BCE term where ``w_eff > 0``, the early stop, C3, C4 and the
    hand-off of the warped points to ``aux``. The eager loop calls it, and
    a captured block records it."""
    p, m, v, x, y, aux = (t[k] for k in ("p", "m", "v", "x", "y", "aux"))

    def step():
        if pcfg.nonrigidity_est:
            warped, nr = level_warp_fwd_nr(p, x, level, pcfg)
        else:
            warped, nr = level_warp_fwd(p, x, level, pcfg), None
        _, cidx, _, rarg = nn_argmin_dual(warped, y, t["xv"], t["yv"])
        loss, g = _chamfer_glue(warped, cidx, rarg, y, t["xv"], t["yv"],
                                t["x_len"], t["y_len"], trunc)
        if n_ldmk > 0:
            diff = (warped - t["ltgt"]) * t["lmask"][:, None]
            loss = torch.sum(diff * diff) / t["lcount"] + w_cd * loss
            g = (2.0 / t["lcount"]) * diff + w_cd * g
        g_nr = t.get("zeros_nr")
        if w_eff > 0:
            # the BCE of nr against zeros over all valid rows and its exact
            # gradient, in plain torch as the JAX package computes it in XLA
            # (reference registration.py:216-220)
            reg, vjp = torch.func.vjp(
                lambda q: bce_with_zeros_target(q, t["row_valid"]), nr)
            loss = loss + w_eff * reg
            (g_nr,) = vjp(torch.tensor(w_eff, device=nr.device))
        halt, hold = stop.decide(loss)
        partials = level_warp_bwd(p, x, g, level, pcfg, g_nr)
        adam_step(p, m, v, partials, stop.applied,
                  hold.to(torch.float32), lcfg.lr)
        stop.advance(loss, halt, hold)
        torch.where(halt, aux, warped, out=aux)

    return step


def _graph_level(t: dict[str, Tensor], shapes, args: tuple):
    """The level loop as replays of its shape's captured block, where
    ``_GRAPHS`` plans one: (params, aux, stats), each a clone, so that
    nothing handed out shares memory with the graph's tensors (the next
    level's input is this one's aux, and callers keep what levels return).
    ``args`` are :func:`_level_step`'s after ``t`` and the stop. None where
    the eager loop runs instead."""
    graphs = _GRAPHS
    if not graphs.lock.acquire(blocking=False):
        return None
    try:
        x = t["x"]
        key = level_graph_key(x.device, x.shape[0], t["y"].shape[0], *args)
        plan, graph = graphs.plan(key)
        if plan == graphs.EAGER:
            return None
        if plan == graphs.CAPTURE:
            graph = _capture_level(t, graphs.pool(), args)
            graphs.store(key, graph)
            if graph is None:
                return None
        else:
            graph.load(t)
        replays = graph.run()
        timers.count("fused_level.blocks", replays)
        timers.count("fused_level.graph_replays", replays)
        graph.stop.count_noops(replays * SYNC_EVERY)
        out = graph.tensors
        return (pyramid.unravel(out["p"].clone(), shapes), out["aux"].clone(),
                {k: s.clone() for k, s in graph.stop.stats().items()})
    finally:
        graphs.lock.release()


def _capture_level(t: dict[str, Tensor], pool, args: tuple):
    """Capture a block of ``SYNC_EVERY`` exact iterations on copies of
    ``t`` (which stays as it was): the graph, or None where the capture
    failed and the level is to run eagerly. Copies, because ``t``'s
    points, masks and target may be the caller's own tensors (``.to`` and
    ``.contiguous`` hand back their input where nothing changes), and each
    later level of the key copies its inputs into the graph's."""
    static = {k: s.clone() for k, s in t.items()}
    _, _, lcfg, *_ = args
    stop = EarlyStop(lcfg, t["x"].device)
    step = _level_step(static, stop, *args)
    try:
        graph = _LevelGraph(static, stop, step, pool)
    except RuntimeError as err:
        warnings.warn(f"run_fused_level: the capture of a level's block "
                      f"failed, the level runs eagerly: {err}")
        timers.count("fused_level.graph_failures")
        return None
    timers.count("fused_level.graph_captures")
    return graph


def run_fused_level(lvl_params: dict, pts: Tensor, pts_valid: Tensor,
                    t_sample: Tensor, t_valid: Tensor, level: int,
                    pcfg: pyramid.NDPConfig, lcfg, trunc: float = 1e9,
                    n_ldmk: int = 0, tgt_ldmk: Tensor | None = None,
                    ldmk_valid: Tensor | None = None, w_cd: float = 1.0,
                    w_reg: float = 0.0):
    """Adam-optimize one pyramid level with the fused iteration.

    Drop-in for the unfused level loop (``solve/loop.run_adam_loop`` with
    ``truncated_chamfer``): the same 3-way early stop, the same pre-step
    warped hand-off, the same optax Adam. With ``n_ldmk > 0`` (landmark +
    chamfer mode) ``pts`` is [ldmk ; sample]: the first ``n_ldmk`` rows
    carry the masked mean-squared landmark term against ``tgt_ldmk``, and
    the chamfer term, scaled by ``w_cd`` and truncated at ``trunc``, sees
    only the sample rows (landmark rows are masked out of both sweep
    directions and the glue). With ``pcfg.nonrigidity_est`` C2 applies the
    level > 0 nonrigidity gate and the loss adds ``w_reg`` times the BCE
    of the nonrigidity against zeros at level > 0, whose gradient C3 takes
    as the nonrigidity's cotangent.

    A level runs one of two ways, both calling the one iteration of
    :func:`_level_step`. On CUDA tensors, without the BCE term, a shape
    seen before (:class:`LevelGraphs`) runs as replays of one captured CUDA
    graph of ``SYNC_EVERY`` iterations, the host reading the stop flag
    after each: the same kernels with the same arguments in the same
    order, so the same result as the eager loop, bit for bit, with one
    host launch a block. Every other level runs the eager loop
    (:meth:`EarlyStop.run`). Counters (while the profiler records):
    ``fused_level.blocks`` (blocks of up to ``SYNC_EVERY`` calls issued by
    the loop, either way), ``fused_level.graph_replays``,
    ``fused_level.graph_captures`` and ``fused_level.graph_failures``.

    Returns (updated level params dict, warped pts [N, 3] of the last
    evaluation, stats {iters, loss}).
    """
    if n_ldmk == 0:
        covered = supports_fused_iteration(pcfg, w_reg)
    else:
        covered = supports_fused_iteration_ldmk(pcfg, w_reg, n_ldmk)
    if not covered:
        raise ValueError("run_fused_level: configuration not covered by the "
                         "kernels; use the unfused loop")
    shapes = pyramid.level_shapes(pcfg)
    t = _level_tensors(lvl_params, pts, pts_valid, t_sample, t_valid, n_ldmk,
                       tgt_ldmk, ldmk_valid, pcfg)
    # the regulariser's weight, gated at level 0 (where nr is all ones)
    w_eff = float(w_reg) if pcfg.nonrigidity_est and level > 0 else 0.0
    args = (level, pcfg, lcfg, trunc, n_ldmk, w_cd, w_eff)
    if w_eff == 0 and t["x"].is_cuda:
        out = _graph_level(t, shapes, args)
        if out is not None:
            return out
    stop = EarlyStop(lcfg, t["x"].device)
    issued = stop.run(_level_step(t, stop, *args))
    timers.count("fused_level.blocks", -(-issued // SYNC_EVERY))
    return pyramid.unravel(t["p"], shapes), t["aux"], stop.stats()


def ldmk_iteration_plain(p: Tensor, m: Tensor, v: Tensor, x: Tensor,
                         tgt: Tensor, mask: Tensor, count: Tensor,
                         stop: EarlyStop, aux: Tensor, level: int,
                         pcfg: pyramid.NDPConfig, lr: float) -> None:
    """Plain version of kernel C5: one landmark-only iteration, from the
    plain warp, ``torch.func.vjp`` and :func:`adam_step_plain`. Updates
    p, m, v and aux in place and advances ``stop``."""
    warped, vjp = torch.func.vjp(lambda f: _plain_warp(f, x, level, pcfg), p)
    diff = (warped - tgt) * mask[:, None]
    loss = torch.sum(diff * diff) / count
    halt, hold = stop.decide(loss)
    (g,) = vjp((2.0 / count) * diff)
    adam_step_plain(p, m, v, g[None], stop.applied, hold.to(torch.float32),
                    lr)
    stop.advance(loss, halt, hold)
    aux.copy_(torch.where(halt, aux, warped))


def ldmk_blocks(n: int, pcfg: pyramid.NDPConfig,
                device: torch.device) -> int:
    """C5's grid for n landmark rows on ``device``: one block a tile of
    :func:`ldmk_tile` rows, or as many as the card holds at once
    (``dp_ldmk_blocks``: the kernel's occupancy x the SMs)."""
    with torch.cuda.device(device):
        got = cuda_lib.query("dp_ldmk_blocks", [I] * 6, n,
                             *_layout_args(pcfg), ldmk_tile(n, pcfg))
    if got <= 0:
        raise RuntimeError(f"ldmk_iteration: no grid for {n} rows "
                           f"(CUDA error {-got})")
    return got


def ldmk_scratch(n: int, pcfg: pyramid.NDPConfig,
                 device: torch.device) -> dict[str, Tensor]:
    """C5's buffers for n landmark rows: a gradient row, its flag (the
    row holds a VJP) and a loss share for each block of the grid
    (:func:`ldmk_blocks`)."""
    n_blocks = ldmk_blocks(n, pcfg, device)
    f32 = dict(dtype=torch.float32, device=device)
    return {"partial": torch.empty((n_blocks, level_param_count(pcfg)), **f32),
            "full": torch.empty(n_blocks, dtype=torch.int32, device=device),
            "ploss": torch.empty(n_blocks, **f32)}


def ldmk_iteration(p: Tensor, m: Tensor, v: Tensor, x: Tensor, tgt: Tensor,
                   mask: Tensor, count: Tensor, stop: EarlyStop, aux: Tensor,
                   level: int, pcfg: pyramid.NDPConfig, lr: float,
                   scratch: dict[str, Tensor] | None = None) -> None:
    """One landmark-only iteration of the level loop: warp of the landmark
    rows x [N, 3], loss sum(((warped - tgt) * mask)^2) / count, the 3-way
    early stop on ``stop``, the VJP of (2 / count) * diff and the held
    Adam step on p, m, v; aux [N, 3] takes the warped rows unless the
    iteration started halted. Kernel C5 on CUDA tensors (``scratch`` from
    :func:`ldmk_scratch`, made here when not given), the plain version on
    CPU tensors. Everything is updated in place."""
    state = (stop.loss, stop.loss_prev, stop.counter, stop.done, stop.it,
             stop.applied)
    if on_cpu(p, m, v, x, tgt, mask, count, aux, *state):
        ldmk_iteration_plain(p, m, v, x, tgt, mask, count, stop, aux, level,
                             pcfg, lr)
        return
    if pcfg.nonrigidity_est:
        raise ValueError("ldmk_iteration: C5 has no nonrigidity head")
    _check_level("ldmk_iteration", p, x, pcfg, tgt, aux)
    check_cuda("ldmk_iteration", p, m, v, mask, count, stop.loss,
               stop.loss_prev, stop.applied)
    check_cuda("ldmk_iteration", stop.counter, stop.it, dtype=torch.int32)
    check_cuda("ldmk_iteration", stop.done, dtype=torch.bool)
    n = x.shape[0]
    if m.shape != p.shape or v.shape != p.shape or mask.shape != (n,) \
            or count.numel() != 1 or any(t.numel() != 1 for t in state):
        raise ValueError("ldmk_iteration: expected m, v like p, mask [N] and "
                         "scalar count and stop state")
    if n > LDMK_MAX_ROWS:
        raise ValueError(f"ldmk_iteration: C5 takes at most {LDMK_MAX_ROWS} "
                         "rows")
    if scratch is None:
        scratch = ldmk_scratch(n, pcfg, x.device)
    partial, full, ploss = scratch["partial"], scratch["full"], \
        scratch["ploss"]
    rows = partial.shape[0]
    if partial.shape[1:] != p.shape or full.shape != (rows,) \
            or ploss.shape != (rows,):
        raise ValueError("ldmk_iteration: scratch made for another shape")
    cfg = stop.cfg
    LDMK_ITERATION.launch(
        p.data_ptr(), m.data_ptr(), v.data_ptr(), x.data_ptr(),
        tgt.data_ptr(), mask.data_ptr(), n, *_layout_args(pcfg),
        _freq(level, pcfg.k0), float(pcfg.mlp_scale), count.data_ptr(),
        *(t.data_ptr() for t in state), int(cfg.iters),
        int(cfg.max_break_count), float(cfg.break_threshold_ratio),
        float(cfg.loss_eps), float(lr), ADAM_B1, ADAM_B2, 1.0 - ADAM_B1,
        1.0 - ADAM_B2, ADAM_EPS, partial.data_ptr(), full.data_ptr(),
        ploss.data_ptr(), aux.data_ptr(), rows, ldmk_tile(n, pcfg))


def run_fused_level_ldmk(lvl_params: dict, pts: Tensor, ldmk_valid: Tensor,
                         tgt_ldmk: Tensor, level: int,
                         pcfg: pyramid.NDPConfig, lcfg):
    """Adam-optimize one pyramid level on the landmark L2 term alone, one
    C5 launch per iteration.

    Drop-in for the unfused level loop in landmark mode with ``w_cd == 0``
    (``pts`` are the landmark rows): the same loss (masked mean squared
    distance), 3-way early stop, pre-step warped hand-off and optax Adam.
    Returns (updated level params dict, warped pts [N, 3], stats {iters,
    loss}).
    """
    if not supports_fused_iteration_ldmk(pcfg, 0.0, pts.shape[0]):
        raise ValueError("run_fused_level_ldmk: configuration not covered "
                         "by the kernels; use the unfused loop")
    shapes = pyramid.level_shapes(pcfg)
    p = pyramid.ravel(lvl_params).to(torch.float32).contiguous().clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    x = pts.to(torch.float32).contiguous()
    tgt = tgt_ldmk.to(torch.float32).contiguous()
    mask = ldmk_valid.to(torch.float32).contiguous()
    count = torch.clamp_min(mask.sum(), 1.0)
    stop = EarlyStop(lcfg, x.device)
    aux = x.clone()
    scratch = None if x.device.type == "cpu" else \
        ldmk_scratch(x.shape[0], pcfg, x.device)
    stop.run(lambda: ldmk_iteration(p, m, v, x, tgt, mask, count, stop, aux,
                                    level, pcfg, lcfg.lr, scratch))
    return pyramid.unravel(p, shapes), aux, stop.stats()


# ---------------------------------------------------------------------------
# The fused NSFP loop (the Neural Prior baseline): C10, C1, glue + C6, C11, C4
# ---------------------------------------------------------------------------

def nsfp_shapes(ncfg: baselines.NSFPConfig) -> list[dict]:
    """Shapes of the NSFP layer list (``models.baselines.init_nsfp_params``)."""
    dims = baselines.nsfp_dims(ncfg)
    return [{"w": (dims[i], dims[i + 1]), "b": (dims[i + 1],)}
            for i in range(ncfg.n_layers)]


def nsfp_param_count(ncfg: baselines.NSFPConfig) -> int:
    """Length of the flat NSFP parameter vector (116,483 at 9 x 128)."""
    w, nl = ncfg.width, ncfg.n_layers
    return 4 * w + (nl - 2) * (w + w * w) + 3 + 3 * w


def nsfp_params_to_flat(params: list[dict]) -> Tensor:
    """NSFP layer list [{w [in, out], b [out]}] -> the flat f32 vector the
    kernels read: per layer its bias, then its weight (row-major), the
    order of JAX's ``ravel_pytree`` (``csrc/nsfp.cu``). The counterpart of
    the JAX package's ``nsfp_params_to_t``."""
    return pyramid.ravel(params).to(torch.float32).contiguous()


def nsfp_flat_to_params(flat: Tensor, ncfg: baselines.NSFPConfig
                        ) -> list[dict]:
    """Inverse of :func:`nsfp_params_to_flat` (views of ``flat``)."""
    return pyramid.unravel(flat, nsfp_shapes(ncfg))


def nsfp_fwd_smem(ncfg: baselines.NSFPConfig, tile: int) -> int:
    """Shared memory of one C10 block of ``tile`` points in bytes
    (``csrc/nsfp.cu``): two activation buffers as rows of
    :func:`row_floats`, and the points."""
    return 4 * tile * (2 * row_floats(ncfg.width) + 3)


def nsfp_bwd_smem(ncfg: baselines.NSFPConfig, tile: int = BWD_TILE) -> int:
    """Shared memory of one C11 block of ``tile`` points in bytes
    (``csrc/nsfp.cu``): the activations of every layer but the last and
    two gradient buffers as rows of :func:`row_floats`, and the points and
    their cotangents. Where it exceeds ``SMEM_LIMIT``, :func:`nsfp_bwd`
    hands C11 those buffers in device memory instead."""
    return 4 * tile * ((ncfg.n_layers + 1) * row_floats(ncfg.width) + 6)


def nsfp_fwd_tile(n: int, ncfg: baselines.NSFPConfig) -> int:
    """Points per C10 block for n points: C3's one-wave rule
    (:func:`bwd_tile`) with C10's shared memory (:func:`nsfp_fwd_smem`;
    2000 points: 125 blocks of 16). The warp of a point does not depend on
    its tile."""
    return _one_wave_tile(n, nsfp_fwd_smem, ncfg)


def nsfp_bwd_tile(n: int, ncfg: baselines.NSFPConfig) -> int:
    """Points per C11 block for n points: C3's one-wave rule
    (:func:`bwd_tile`) with C11's shared memory (:func:`nsfp_bwd_smem`;
    2000 points: 125 blocks of 16). C11 writes ``-(-n // tile)`` partial
    rows."""
    return _one_wave_tile(n, nsfp_bwd_smem, ncfg)


def supports_fused_nsfp(ncfg: baselines.NSFPConfig) -> bool:
    """What C10 / C11 cover: ReLU, at least two layers and a width that is
    a multiple of 4 up to 256, at any depth (C11's buffers go to device
    memory where they exceed a block's shared memory: :func:`nsfp_bwd`)."""
    return (ncfg.act == "relu" and ncfg.n_layers >= 2
            and 4 <= ncfg.width <= MAX_WIDTH and ncfg.width % 4 == 0)


def nsfp_fwd_plain(flat: Tensor, x: Tensor, ncfg: baselines.NSFPConfig
                   ) -> Tensor:
    """Plain version of kernel C10: x + nsfp_flow(x) from the flat vector."""
    return x + baselines.nsfp_flow(nsfp_flat_to_params(flat, ncfg), x, ncfg)


def nsfp_bwd_plain(flat: Tensor, x: Tensor, g: Tensor,
                   ncfg: baselines.NSFPConfig) -> Tensor:
    """Plain version of kernel C11: ``torch.func.vjp`` of the plain warp for
    the cotangent g [N, 3], as one partial row [1, P]."""
    _, vjp = torch.func.vjp(lambda f: nsfp_fwd_plain(f, x, ncfg), flat)
    return vjp(g)[0][None]


def _check_nsfp(name: str, flat: Tensor, x: Tensor,
                ncfg: baselines.NSFPConfig, *more: Tensor) -> None:
    check_cuda(name, flat, x, *more)
    if not supports_fused_nsfp(ncfg):
        raise ValueError(f"{name}: the kernel covers ReLU, >= 2 layers and a "
                         f"width that is a multiple of 4 up to {MAX_WIDTH}")
    if flat.shape != (nsfp_param_count(ncfg),):
        raise ValueError(f"{name}: flat params of shape {tuple(flat.shape)}")
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"{name}: points must be [N, 3]")
    for t in more:
        if t.shape != x.shape:
            raise ValueError(f"{name}: cotangent must be [N, 3]")


def nsfp_fwd(flat: Tensor, x: Tensor, ncfg: baselines.NSFPConfig) -> Tensor:
    """The NSFP warp x + mlp(x) of x [N, 3] from the flat parameter vector:
    kernel C10 on CUDA tensors, the plain version on CPU tensors."""
    if on_cpu(flat, x):
        return nsfp_fwd_plain(flat, x, ncfg)
    _check_nsfp("nsfp_fwd", flat, x, ncfg)
    out = torch.empty_like(x)
    NSFP_FWD.launch(flat.data_ptr(), x.data_ptr(), x.shape[0], ncfg.width,
                    ncfg.n_layers, out.data_ptr(),
                    nsfp_fwd_tile(x.shape[0], ncfg))
    return out


def nsfp_bwd(flat: Tensor, x: Tensor, g: Tensor,
             ncfg: baselines.NSFPConfig) -> Tensor:
    """Parameter gradient of the NSFP warp for the cotangent g [N, 3], as
    partial rows [n_blocks, P] whose sum is the gradient: kernel C11 on
    CUDA tensors (one row per block of :func:`nsfp_bwd_tile` points,
    summed by :func:`adam_step` in block order), the plain VJP on CPU
    tensors (one row)."""
    if on_cpu(flat, x, g):
        return nsfp_bwd_plain(flat, x, g, ncfg)
    _check_nsfp("nsfp_bwd", flat, x, ncfg, g)
    n = x.shape[0]
    tile = nsfp_bwd_tile(n, ncfg)
    n_blocks = -(-n // tile)
    f32 = dict(dtype=torch.float32, device=flat.device)
    partial = torch.empty((n_blocks, flat.shape[0]), **f32)
    scratch = None
    if nsfp_bwd_smem(ncfg, tile) > SMEM_LIMIT:
        scratch = torch.empty((n_blocks, (ncfg.n_layers + 1) * tile
                               * row_floats(ncfg.width)), **f32)
    NSFP_BWD.launch(flat.data_ptr(), x.data_ptr(), g.data_ptr(), n,
                    ncfg.width, ncfg.n_layers, partial.data_ptr(), n_blocks,
                    tile, None if scratch is None else scratch.data_ptr())
    return partial


def run_fused_nsfp(params: list[dict], s_sample: Tensor, s_valid: Tensor,
                   t_sample: Tensor, t_valid: Tensor, lcfg,
                   ncfg: baselines.NSFPConfig = baselines.NSFPConfig()):
    """Adam-optimize the NSFP flow field with the fused iteration: C10,
    C1, the chamfer glue with C6, C11, C4, one launch each an iteration.

    Drop-in for the unfused ``solve/baselines.optimize_nsfp`` loop (the
    plain chamfer objective, trunc 1e9, the same 3-way early stop and
    optax Adam). Returns (updated layer list, stats {iters, loss}).
    """
    if not supports_fused_nsfp(ncfg):
        raise ValueError("run_fused_nsfp: configuration not covered by the "
                         "kernels; use the unfused loop")
    p = nsfp_params_to_flat(params).clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    x = s_sample.to(torch.float32).contiguous()
    y = t_sample.to(torch.float32).contiguous()
    xv = s_valid.to(torch.bool).contiguous()
    yv = t_valid.to(torch.bool).contiguous()
    x_len = torch.clamp_min(xv.sum(), 1).to(torch.float32)
    y_len = torch.clamp_min(yv.sum(), 1).to(torch.float32)
    stop = EarlyStop(lcfg, x.device)

    def step():
        warped = nsfp_fwd(p, x, ncfg)
        _, cidx, _, rarg = nn_argmin_dual(warped, y, xv, yv)
        loss, g = _chamfer_glue(warped, cidx, rarg, y, xv, yv, x_len, y_len,
                                1e9)
        halt, hold = stop.decide(loss)
        partials = nsfp_bwd(p, x, g, ncfg)
        adam_step(p, m, v, partials, stop.applied, hold.to(torch.float32),
                  lcfg.lr)
        stop.advance(loss, halt, hold)

    stop.run(step)
    return nsfp_flat_to_params(p, ncfg), stop.stats()
