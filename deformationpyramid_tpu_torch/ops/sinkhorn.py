"""Log-domain (unbalanced, debiased) Sinkhorn divergence.

Counterpart of ``deformationpyramid_tpu/ops/sinkhorn.py``, which replaces
the reference's geomloss ``SamplesLoss("sinkhorn", p=2, blur, reach)``
(``model/registration.py:543-572``). Semantics:

* cost C(x,y) = ||x-y||^2 / 2  (geomloss p=2 convention),
* entropic blur: epsilon = blur^2,
* unbalanced marginal KL penalty rho = reach^2 (reach=None -> balanced),
* debiased divergence S(a,b) = OT(a,b) - (OT(a,a)+OT(b,b))/2,
* a fixed geometric epsilon-annealing schedule from the point-cloud
  diameter down to blur^2 (not geomloss's multiscale scaling loop).

Everything is differentiable tensor code. The [N, M] cost product is a
``torch.matmul`` in exact float32 (no TF32): squared distances of centred
clouds cancel digits, and the JAX package computes this product outside
any kernel too.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def _softmin(eps: Tensor, C: Tensor, f: Tensor) -> Tensor:
    """softmin_eps over columns: -eps * logsumexp((f - C)/eps) per row."""
    return -eps * torch.logsumexp((f[None, :] - C) / eps, dim=1)


def _cost(x: Tensor, y: Tensor) -> Tensor:
    """C_ij = ||x_i - y_j||^2 / 2 (geomloss p=2)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1)
    d = x2 + y2[None, :] - 2.0 * (x @ y.T)
    return 0.5 * torch.clamp_min(d, 0.0)


def sinkhorn_potentials(x: Tensor, y: Tensor, blur: float,
                        reach: float | None, n_iters: int = 20
                        ) -> tuple[Tensor, Tensor]:
    """Symmetric-update sinkhorn with eps-annealing; returns dual (f, g)."""
    n, m = x.shape[0], y.shape[0]
    loga = torch.full((n,), -math.log(n), dtype=x.dtype, device=x.device)
    logb = torch.full((m,), -math.log(m), dtype=x.dtype, device=x.device)
    C = _cost(x, y)
    Ct = C.T
    eps_target = blur ** 2
    diam2 = torch.clamp_min(torch.max(C), eps_target)

    # damping for unbalanced OT: lam = rho / (rho + eps)
    def damping(eps):
        if reach is None:
            return 1.0
        rho = reach ** 2
        return rho / (rho + eps)

    f = torch.zeros((n,), dtype=x.dtype, device=x.device)
    g = torch.zeros((m,), dtype=x.dtype, device=x.device)
    for i in range(n_iters):
        # geometric annealing from diameter^2 to blur^2
        frac = i / max(n_iters - 1, 1)
        eps = torch.exp(torch.log(diam2) * (1 - frac)
                        + math.log(eps_target) * frac)
        lam = damping(eps)
        ft = lam * _softmin(eps, C, g + eps * logb)
        gt = lam * _softmin(eps, Ct, f + eps * loga)
        # symmetric (averaged) updates for stability
        f, g = 0.5 * (f + ft), 0.5 * (g + gt)
    # one final sharp update at the target eps
    lam = damping(eps_target)
    f = lam * _softmin(eps_target, C, g + eps_target * logb)
    g = lam * _softmin(eps_target, Ct, f + eps_target * loga)
    return f, g


def _ot_value(x: Tensor, y: Tensor, blur: float, reach: float | None,
              n_iters: int) -> Tensor:
    """<a, f> + <b, g> under uniform weights (balanced); for unbalanced the
    rho-KL transform of the potentials (geomloss value convention)."""
    f, g = sinkhorn_potentials(x, y, blur, reach, n_iters)
    if reach is None:
        return torch.mean(f) + torch.mean(g)
    rho = reach ** 2
    return rho * (torch.mean(1.0 - torch.exp(-f / rho))
                  + torch.mean(1.0 - torch.exp(-g / rho)))


def sinkhorn_divergence(x: Tensor, y: Tensor, blur: float = 0.1,
                        reach: float | None = 1.0, n_iters: int = 20,
                        debias: bool = True) -> Tensor:
    """Differentiable sinkhorn divergence S_eps(x, y) with uniform weights."""
    val = _ot_value(x, y, blur, reach, n_iters)
    if debias:
        val = val - 0.5 * (_ot_value(x, x, blur, reach, n_iters)
                           + _ot_value(y, y, blur, reach, n_iters))
    return val
