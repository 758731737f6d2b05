"""Baseline registration solvers: NSFP, Nerfies, Sinkhorn.

Counterpart of ``deformationpyramid_tpu/solve/baselines.py`` (the reference
dispatch targets, ``model/registration.py:106-123``):

* ``register_nsfp``      <- optimize_neural_SFlow   (``:470-540``)
* ``register_nerfies``   <- optimize_Nerfies        (``:265-339``)
* ``register_sinkhorn``  <- run_optimal_transport   (``:543-572``)

NSFP and Nerfies run the shared early-stop Adam loop (``solve/loop.py``);
NSFP with ``use_fused_iteration`` runs ``ops/fused_iteration.run_fused_nsfp``
(kernels C10, C1, C6, C11, C4). The ``optimize_*`` cores take the initial
parameters, so a caller can start both packages from the same weights.
Pairs are solved one at a time; the device follows the input tensors. The
embedded-deformation baseline (``register_ed``) is not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from ..losses import nerfies_regularization
from ..models.baselines import (NSFPConfig, NerfiesConfig,
                                init_nerfies_params, init_nsfp_params,
                                nerfies_jacobian, nerfies_warp, nsfp_flow)
from ..ops.chamfer import truncated_chamfer
from ..ops.fused_iteration import (nsfp_fwd, nsfp_params_to_flat,
                                   run_fused_nsfp, supports_fused_nsfp)
from ..ops.sinkhorn import sinkhorn_divergence
from .loop import LoopConfig, run_adam_loop
from .registration import (_as_generator, _masked_mean, _random_subset,
                           _random_subset_idx)

Tensor = torch.Tensor


def _valid_or_ones(valid: Tensor | None, pts: Tensor) -> Tensor:
    if valid is None:
        return torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    return valid


def _center_and_sample(gen: torch.Generator, src: Tensor, tgt: Tensor,
                       src_valid: Tensor, tgt_valid: Tensor, samples: int):
    src_mean = _masked_mean(src, src_valid)
    tgt_mean = _masked_mean(tgt, tgt_valid)
    src_c, tgt_c = src - src_mean, tgt - tgt_mean
    s_sample, s_valid = _random_subset(gen, src_c, src_valid,
                                       min(samples, src.shape[0]))
    t_sample, t_valid = _random_subset(gen, tgt_c, tgt_valid,
                                       min(samples, tgt.shape[0]))
    return (src_c, tgt_c, src_mean, tgt_mean, s_sample, s_valid, t_sample,
            t_valid)


def _loop_config(cfg) -> LoopConfig:
    return LoopConfig(iters=cfg.iters, lr=cfg.lr,
                      max_break_count=cfg.max_break_count,
                      break_threshold_ratio=cfg.break_threshold_ratio)


# ---------------------------------------------------------------------------
# NSFP
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NSFPSolverConfig:
    net: NSFPConfig = dataclasses.field(default_factory=NSFPConfig)
    iters: int = 5000
    lr: float = 0.01
    max_break_count: int = 70
    break_threshold_ratio: float = 0.001
    samples: int = 2000
    # the fused iteration (ops/fused_iteration.run_fused_nsfp);
    # None/False = the unfused loop
    use_fused_iteration: bool | None = None


def optimize_nsfp(params: list[dict], s_sample: Tensor, s_valid: Tensor,
                  t_sample: Tensor, t_valid: Tensor, cfg: NSFPSolverConfig):
    """Fixed-shape NSFP core on pre-centred, pre-sampled points, from the
    initial layer list ``params`` -> (params, stats {iters, loss})."""
    lcfg = _loop_config(cfg)
    if cfg.use_fused_iteration:
        return run_fused_nsfp(params, s_sample, s_valid, t_sample, t_valid,
                              lcfg, cfg.net)

    def loss_fn(p, it):
        warped = s_sample + nsfp_flow(p, s_sample, cfg.net)
        loss = truncated_chamfer(warped, t_sample, x_valid=s_valid,
                                 y_valid=t_valid, trunc=1e9)
        return loss, None

    params, _, stats = run_adam_loop(loss_fn, params, lcfg)
    return params, stats


@torch.no_grad()
def nsfp_warp(params: list[dict], x: Tensor, cfg: NSFPSolverConfig) -> Tensor:
    """The fitted field applied to x [N, 3] (the full cloud): x + flow.
    With the fused iteration it goes through kernel C10 as the solve did;
    otherwise the plain ``nsfp_flow``."""
    if cfg.use_fused_iteration and supports_fused_nsfp(cfg.net):
        return nsfp_fwd(nsfp_params_to_flat(params), x.contiguous(), cfg.net)
    return x + nsfp_flow(params, x, cfg.net)


def register_nsfp(key: int | torch.Generator, src: Tensor, tgt: Tensor,
                  cfg: NSFPSolverConfig, src_valid: Tensor | None = None,
                  tgt_valid: Tensor | None = None):
    """Fit a Neural Prior flow field; returns (warped full cloud, stats)."""
    gen = _as_generator(key)
    src_valid = _valid_or_ones(src_valid, src)
    tgt_valid = _valid_or_ones(tgt_valid, tgt)
    params = init_nsfp_params(gen, cfg.net, device=src.device)
    src_c, _, _, tgt_mean, s_sample, s_valid, t_sample, t_valid = \
        _center_and_sample(gen, src, tgt, src_valid, tgt_valid, cfg.samples)
    params, stats = optimize_nsfp(params, s_sample, s_valid, t_sample,
                                  t_valid, cfg)
    return nsfp_warp(params, src_c, cfg) + tgt_mean, stats


# ---------------------------------------------------------------------------
# Nerfies
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NerfiesSolverConfig:
    net: NerfiesConfig = dataclasses.field(default_factory=NerfiesConfig)
    iters: int = 5000
    lr: float = 0.01
    max_break_count: int = 70
    break_threshold_ratio: float = 0.001
    samples: int = 2000
    w_elastic: float = 0.001


def nerfies_net(cfg: NerfiesSolverConfig) -> NerfiesConfig:
    """The field's config with the window schedule tied to the solver's
    iteration cap."""
    return dataclasses.replace(cfg.net, max_iter=cfg.iters)


def optimize_nerfies(params: dict, s_sample: Tensor, s_valid: Tensor,
                     t_sample: Tensor, t_valid: Tensor,
                     cfg: NerfiesSolverConfig):
    """Fixed-shape Nerfies core from the initial ``params`` -> (params,
    stats); the final full-cloud warp must use ``stats['iters'] - 1`` as
    the posenc-window iteration (reference ``registration.py:333`` uses the
    loop variable left by the break)."""
    net = nerfies_net(cfg)

    def loss_fn(p, it):
        warped = nerfies_warp(p, s_sample, it, net)
        J = nerfies_jacobian(p, s_sample, it, net)
        reg = nerfies_regularization(J)
        cd = truncated_chamfer(warped, t_sample, x_valid=s_valid,
                               y_valid=t_valid, trunc=1e9)
        return cd + cfg.w_elastic * reg, None

    params, _, stats = run_adam_loop(loss_fn, params, _loop_config(cfg))
    return params, stats


def register_nerfies(key: int | torch.Generator, src: Tensor, tgt: Tensor,
                     cfg: NerfiesSolverConfig,
                     src_valid: Tensor | None = None,
                     tgt_valid: Tensor | None = None):
    """Nerfies SE(3)-field warp with the elastic log-singular-value
    regulariser; returns (warped full cloud, stats)."""
    gen = _as_generator(key)
    src_valid = _valid_or_ones(src_valid, src)
    tgt_valid = _valid_or_ones(tgt_valid, tgt)
    net = nerfies_net(cfg)
    params = init_nerfies_params(gen, net, device=src.device)
    src_c, _, _, tgt_mean, s_sample, s_valid, t_sample, t_valid = \
        _center_and_sample(gen, src, tgt, src_valid, tgt_valid, cfg.samples)
    params, stats = optimize_nerfies(params, s_sample, s_valid, t_sample,
                                     t_valid, cfg)
    # final full-cloud warp at the last *executed* iteration index
    last_it = torch.clamp_min(stats["iters"] - 1, 0)
    with torch.no_grad():
        warped_full = nerfies_warp(params, src_c, last_it, net) + tgt_mean
    return warped_full, stats


# ---------------------------------------------------------------------------
# Sinkhorn (direct coordinate descent on the OT divergence)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SinkhornSolverConfig:
    blur: float = 0.1
    reach: float | None = 1.0
    n_steps: int = 11
    lr: float = 1.0
    samples: int = 2000
    ot_iters: int = 20


def sinkhorn_descent(s_sample: Tensor, t_sample: Tensor,
                     cfg: SinkhornSolverConfig) -> Tensor:
    """``n_steps`` Euler steps of the sample coordinates down the sinkhorn
    divergence, each scaled by the point count (reference ``:569``)."""
    x = s_sample.detach()
    for _ in range(cfg.n_steps):
        x = x.requires_grad_(True)
        div = sinkhorn_divergence(x, t_sample, blur=cfg.blur,
                                  reach=cfg.reach, n_iters=cfg.ot_iters)
        (g,) = torch.autograd.grad(div, x)
        x = (x - cfg.lr * x.shape[0] * g).detach()
    return x


def register_sinkhorn(key: int | torch.Generator, src: Tensor, tgt: Tensor,
                      cfg: SinkhornSolverConfig,
                      src_valid: Tensor | None = None,
                      tgt_valid: Tensor | None = None):
    """Mirrors ``run_optimal_transport`` (``registration.py:543-572``): no
    centring, moves the sampled subset directly; returns (moved samples,
    sample validity mask, sample indices into ``src``, stats)."""
    gen = _as_generator(key)
    src_valid = _valid_or_ones(src_valid, src)
    tgt_valid = _valid_or_ones(tgt_valid, tgt)
    s_sample, s_valid, s_idx = _random_subset_idx(
        gen, src, src_valid, min(cfg.samples, src.shape[0]))
    t_sample, _ = _random_subset(gen, tgt, tgt_valid,
                                 min(cfg.samples, tgt.shape[0]))
    moved = sinkhorn_descent(s_sample, t_sample, cfg)
    stats = {"iters": torch.tensor(cfg.n_steps, dtype=torch.int32,
                                   device=src.device)}
    return moved, s_valid, s_idx, stats
