"""Per-pair test-time-optimization registration engine.

Counterpart of ``deformationpyramid_tpu/solve/registration.py`` (reference
``Registration.optimize_deformation_pyramid``,
``model/registration.py:126-262``):

  mean-centre both clouds -> random ``samples``-subset of each ->
  level-by-level Adam (fresh optimizer per level, 3-way early stop) ->
  full-cloud warp through all levels -> re-add the target mean.

The points handed to the next level are the warp evaluated *before* the
level's final optimizer step (``registration.py:241-249``). With landmarks
(the solver half of LNDP) the loss is the masked mean-squared landmark
distance, plus ``w_cd`` times the chamfer truncated at ``trunc_cd`` when
``w_cd > 0`` (then the optimized points are [landmarks ; sample]).

With ``use_fused_iteration`` set and a configuration the kernels cover,
each level runs:

  =====================================  ==================================
  chamfer mode (``w_reg > 0`` with the   ``run_fused_level`` (C2, C1, C3, C4
  nonrigidity head too), or landmarks    every iteration: a captured graph
  + w_cd > 0                             or the eager loop)
  landmarks, w_cd == 0, use_fused_ldmk   ``run_fused_level_ldmk`` (C5)
  otherwise                              the unfused loop
  =====================================  ==================================

The unfused loop is autograd through the level warp and the loss, as the
JAX package routes it (``_solve_level``): the warp is the plain one, or
with ``use_fused`` (SE3 + axis_angle, ``w_reg == 0``) the standalone
kernels C2 / C3 + C13 (``ops/fused_level.py``; with ``transposed`` too, the
same kernels on [3, N] points); the loss is ``truncated_chamfer`` on C1, or
with ``use_fused_chamfer`` kernel C12 (``ops/chamfer_fused.py``).
``transposed`` without ``use_fused`` is the plain warp: the JAX package's
``level_warp_t`` computes the same function in a TPU layout, which the
port keeps only as a layout adapter (``models/pyramid.level_warp_t``).
Pairs are solved one at a time; the device follows the input tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from ..losses import bce_with_zeros_target
from ..models.pyramid import (NDPConfig, init_pyramid_params, level_params,
                              level_warp, warp)
from ..ops.chamfer import truncated_chamfer
from ..ops.chamfer_fused import chamfer_l1_fused
from ..ops.fused_iteration import (run_fused_level, run_fused_level_ldmk,
                                   supports_fused_iteration,
                                   supports_fused_iteration_ldmk)
from ..ops.fused_level import (fused_level_warp, fused_level_warp_t,
                               supports_fused)
from ..utils import timers
from .loop import LoopConfig, run_adam_loop

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Reference ``config/NDP.yaml`` knobs + pyramid config."""

    pyramid: NDPConfig = dataclasses.field(default_factory=NDPConfig)
    iters: int = 500
    lr: float = 0.01
    max_break_count: int = 15
    break_threshold_ratio: float = 0.001
    samples: int = 2000
    w_reg: float = 0.0
    # Carried as in the reference config and the JAX package; the landmark
    # term is not weighted by it there either.
    w_ldmk: float = 0.0
    w_cd: float = 0.0        # chamfer weight in landmark mode
    trunc_cd: float = 0.25   # chamfer truncation in landmark mode (squared)
    # The reference hardcodes trunc=1e9 for the no-landmark objective
    # (``model/registration.py:212``).
    trunc_chamfer: float = 1e9
    loss_eps: float = 1e-4
    # Opt-in routes of the unfused loop, as in the JAX package (None/False
    # = off): the standalone level-warp kernels (ops/fused_level.py), the
    # one-call chamfer loss (ops/chamfer_fused.py), and the [3, N] layout
    # (with use_fused: the same kernels on transposed points).
    use_fused: bool | None = None
    use_fused_chamfer: bool | None = None
    transposed: bool | None = None
    # The fused iteration (ops/fused_iteration.py); None/False = the
    # unfused loop, as in the JAX package's library default.
    use_fused_iteration: bool | None = None
    # The one-launch landmark iteration (kernel C5) for w_cd == 0, on top
    # of use_fused_iteration; None/False = the unfused loop, as in the JAX
    # package's default.
    use_fused_ldmk: bool | None = None

    def loop_config(self) -> LoopConfig:
        return LoopConfig(iters=self.iters, lr=self.lr,
                          max_break_count=self.max_break_count,
                          break_threshold_ratio=self.break_threshold_ratio,
                          loss_eps=self.loss_eps)


def _as_generator(key: int | torch.Generator,
                  device: torch.device | str = "cpu") -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def _solve_level(lvl_params: dict, lvl: int, pts: Tensor, pts_valid: Tensor,
                 t_sample: Tensor, t_valid: Tensor, cfg: SolverConfig,
                 n_ldmk: int = 0, tgt_ldmk: Tensor | None = None,
                 ldmk_valid: Tensor | None = None):
    """Adam-optimize one pyramid level on the sampled source points.

    In landmark mode (``n_ldmk > 0``) ``pts`` starts with the ``n_ldmk``
    landmark rows: all of it when ``w_cd == 0``, [ldmk ; sample] otherwise.
    Returns (updated level params, warped pts of the last evaluation,
    stats {iters, loss}).
    """
    pcfg = cfg.pyramid
    lcfg = cfg.loop_config()
    if cfg.use_fused_iteration:
        if supports_fused_iteration(pcfg, cfg.w_reg, n_ldmk):
            return run_fused_level(lvl_params, pts, pts_valid, t_sample,
                                   t_valid, lvl, pcfg, lcfg,
                                   trunc=cfg.trunc_chamfer, w_reg=cfg.w_reg)
        if supports_fused_iteration_ldmk(pcfg, cfg.w_reg, n_ldmk):
            if cfg.w_cd > 0:
                return run_fused_level(lvl_params, pts, pts_valid, t_sample,
                                       t_valid, lvl, pcfg, lcfg,
                                       trunc=cfg.trunc_cd, n_ldmk=n_ldmk,
                                       tgt_ldmk=tgt_ldmk,
                                       ldmk_valid=ldmk_valid, w_cd=cfg.w_cd)
            if cfg.use_fused_ldmk:
                return run_fused_level_ldmk(lvl_params, pts, ldmk_valid,
                                            tgt_ldmk, lvl, pcfg, lcfg)

    # The opt-in routes of JAX _solve_level: fused (C2 / C3 + C13) only
    # where its gate holds and w_reg == 0, on [3, N] points with
    # transposed; transposed alone is the plain warp.
    fused = bool(cfg.use_fused) and supports_fused(pcfg) and cfg.w_reg == 0
    fused_t = fused and bool(cfg.transposed)
    fused = fused and not fused_t
    pts_t = pts.T.contiguous() if fused_t else None

    def chamfer(wx, wv, trunc):
        if cfg.use_fused_chamfer:
            return chamfer_l1_fused(wx, t_sample, x_valid=wv,
                                    y_valid=t_valid, trunc=trunc)
        return truncated_chamfer(wx, t_sample, x_valid=wv, y_valid=t_valid,
                                 trunc=trunc)

    def loss_fn(p, it):
        if fused_t:
            warped, nr = fused_level_warp_t(p, pts_t, lvl, pcfg).T, None
        elif fused:
            warped, nr = fused_level_warp(p, pts, lvl, pcfg), None
        else:
            warped, nr = level_warp(p, pts, lvl, pcfg)
        if n_ldmk > 0:
            sq = torch.sum((warped[:n_ldmk] - tgt_ldmk) ** 2, dim=-1)
            loss = torch.sum(torch.where(ldmk_valid, sq, 0.0)) \
                / torch.clamp_min(ldmk_valid.sum(), 1)
            if cfg.w_cd > 0:
                loss = loss + cfg.w_cd * chamfer(
                    warped[n_ldmk:], pts_valid[n_ldmk:], cfg.trunc_cd)
        else:
            loss = chamfer(warped, pts_valid, cfg.trunc_chamfer)
        if cfg.w_reg > 0 and lvl > 0:
            loss = loss + cfg.w_reg * bce_with_zeros_target(
                nr, pts_valid)
        return loss, warped

    return run_adam_loop(loss_fn, lvl_params, lcfg, aux_init=pts)


def _random_subset_idx(gen: torch.Generator, pts: Tensor, valid: Tensor,
                       k: int) -> tuple[Tensor, Tensor, Tensor]:
    """Random k-subset of the valid rows, fixed output shape: rows ranked by
    a uniform score (drawn from ``gen`` on the generator's device, then
    moved to the points') with invalid rows last; if fewer than k rows are
    valid the extras come back masked out. Returns (rows, their validity,
    their indices into ``pts``)."""
    score = torch.rand(pts.shape[0], generator=gen,
                       device=gen.device).to(pts.device)
    score = torch.where(valid, score, 2.0)
    idx = torch.topk(-score, k).indices
    return pts[idx], valid[idx], idx


def _random_subset(gen: torch.Generator, pts: Tensor, valid: Tensor, k: int
                   ) -> tuple[Tensor, Tensor]:
    return _random_subset_idx(gen, pts, valid, k)[:2]


def optimize_pyramid(params: dict, pts0: Tensor, pts_valid: Tensor,
                     t_sample: Tensor, t_valid: Tensor, cfg: SolverConfig,
                     n_ldmk: int = 0, tgt_ldmk: Tensor | None = None,
                     ldmk_valid: Tensor | None = None,
                     on_level: Callable | None = None
                     ) -> tuple[dict, dict[str, Tensor]]:
    """Level-by-level Adam on pre-centred, pre-sampled points, starting from
    the stacked initial ``params``. Returns (final stacked params, stats
    {"iters": [m], "loss": [m]}). Reference: the level loop of
    ``optimize_deformation_pyramid`` (``registration.py:166-249``).

    ``on_level``, where given, is called after each level as
    ``on_level(lvl, lvl_params_in, pts_in, (params_out, pts_out, stats))``
    with the level's own tensors; nothing is copied for it."""
    pts = pts0
    per_level, iters, losses = [], [], []
    for lvl in range(cfg.pyramid.m):
        lvl_params = level_params(params, lvl)
        out = _solve_level(lvl_params, lvl, pts, pts_valid, t_sample,
                           t_valid, cfg, n_ldmk, tgt_ldmk, ldmk_valid)
        if on_level is not None:
            on_level(lvl, lvl_params, pts, out)
        new_p, pts, stats = out
        per_level.append(new_p)
        iters.append(stats["iters"])
        losses.append(stats["loss"])
    final = _stack_levels(per_level)
    return final, {"iters": torch.stack(iters), "loss": torch.stack(losses)}


def _stack_levels(levels: list[dict]) -> dict:
    if isinstance(levels[0], dict):
        return {k: _stack_levels([lv[k] for lv in levels]) for k in levels[0]}
    return torch.stack([t.detach() for t in levels])


def _masked_mean(pts: Tensor, valid: Tensor) -> Tensor:
    return (torch.sum(torch.where(valid[:, None], pts, 0.0), dim=0)
            / torch.clamp_min(valid.sum(), 1))[None]


def register_pair(key: int | torch.Generator, src: Tensor, tgt: Tensor,
                  cfg: SolverConfig, src_valid: Tensor | None = None,
                  tgt_valid: Tensor | None = None,
                  src_ldmk: Tensor | None = None,
                  tgt_ldmk: Tensor | None = None,
                  ldmk_valid: Tensor | None = None,
                  params: dict | None = None,
                  on_level: Callable | None = None
                  ) -> tuple[Tensor, dict[str, Tensor]]:
    """Register one (padded) pair; returns (warped full source cloud,
    stats). ``key`` seeds the initial weights and the two random subsets
    (drawn on the CPU, so a seed gives the same draw on every device);
    given ``params`` (stacked, as ``init_pyramid_params`` makes them), the
    solve starts from those instead and ``key`` seeds the subsets alone.
    With ``src_ldmk``/``tgt_ldmk`` [L, 3] (and ``ldmk_valid`` [L], padded
    rows False) the solve is landmark-guided (LNDP). ``on_level`` is
    handed to :func:`optimize_pyramid`."""
    with timers.span("dp::solve"):
        gen = _as_generator(key)
        pcfg = cfg.pyramid
        n_src, n_tgt = src.shape[0], tgt.shape[0]
        if src_valid is None:
            src_valid = torch.ones(n_src, dtype=torch.bool,
                                   device=src.device)
        if tgt_valid is None:
            tgt_valid = torch.ones(n_tgt, dtype=torch.bool,
                                   device=tgt.device)

        if params is None:
            params = init_pyramid_params(gen, pcfg, device=src.device)
        src_mean = _masked_mean(src, src_valid)
        tgt_mean = _masked_mean(tgt, tgt_valid)
        src_c = src - src_mean
        tgt_c = tgt - tgt_mean
        s_sample, s_valid = _random_subset(gen, src_c, src_valid,
                                           min(cfg.samples, n_src))
        t_sample, t_valid = _random_subset(gen, tgt_c, tgt_valid,
                                           min(cfg.samples, n_tgt))

        n_ldmk, tgt_ldmk_c = 0, None
        pts0, pts_valid = s_sample, s_valid
        if src_ldmk is not None:
            n_ldmk = src_ldmk.shape[0]
            if ldmk_valid is None:
                ldmk_valid = torch.ones(n_ldmk, dtype=torch.bool,
                                        device=src.device)
            src_ldmk_c = src_ldmk - src_mean
            tgt_ldmk_c = tgt_ldmk - tgt_mean
            if cfg.w_cd > 0:
                pts0 = torch.cat([src_ldmk_c, s_sample])
                pts_valid = torch.cat([ldmk_valid, s_valid])
            else:
                pts0, pts_valid = src_ldmk_c, ldmk_valid

        final_params, stats = optimize_pyramid(
            params, pts0, pts_valid, t_sample, t_valid, cfg, n_ldmk,
            tgt_ldmk_c, ldmk_valid, on_level)
        with torch.no_grad():
            warped_full, _ = warp(final_params, src_c, pcfg)
        return warped_full + tgt_mean, stats


def make_register_fn(cfg: SolverConfig, landmarks: bool = False):
    """A single-pair registration function with ``cfg`` bound; with
    ``landmarks`` it takes (key, src, tgt, src_ldmk, tgt_ldmk, ldmk_valid,
    src_valid, tgt_valid)."""
    if landmarks:
        def fn(key, src, tgt, src_ldmk, tgt_ldmk, ldmk_valid,
               src_valid=None, tgt_valid=None):
            return register_pair(key, src, tgt, cfg, src_valid, tgt_valid,
                                 src_ldmk, tgt_ldmk, ldmk_valid)
    else:
        def fn(key, src, tgt, src_valid=None, tgt_valid=None):
            return register_pair(key, src, tgt, cfg, src_valid, tgt_valid)
    return fn


def register_batch(keys: Sequence[int | torch.Generator], src: Tensor,
                   tgt: Tensor, cfg: SolverConfig,
                   src_valid: Tensor | None = None,
                   tgt_valid: Tensor | None = None
                   ) -> tuple[Tensor, dict[str, Tensor]]:
    """Register B pairs one after another: keys [B], src [B, N, 3],
    tgt [B, M, 3]. Returns (warped [B, N, 3], stats with a leading B
    axis)."""
    outs, stats = [], []
    for b in range(src.shape[0]):
        w, st = register_pair(keys[b], src[b], tgt[b], cfg,
                              None if src_valid is None else src_valid[b],
                              None if tgt_valid is None else tgt_valid[b])
        outs.append(w)
        stats.append(st)
    return torch.stack(outs), {k: torch.stack([s[k] for s in stats])
                               for k in stats[0]}
