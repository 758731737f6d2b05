"""Plain reference of the Neural Deformation Pyramid solver (NDP, arXiv
2205.12796; the reference program's ``model/nets.py``,
``model/registration.py`` and ``model/loss.py``).

* the initial pyramid: Xavier-uniform weights and torch-default uniform
  biases of every level, drawn from a CPU ``torch.Generator`` in the
  order input, hidden, translation head, rotation head (weights [in, out],
  all levels stacked);
* one level's warp: ``sin``/``cos`` of x 2^(level + 1 + k0) without pi,
  in the order sin x, cos x, sin y, cos y, sin z, cos z; ReLU MLP; heads
  scaled by 1e-3; axis-angle rotation by Rodrigues' formula; SE3;
* one level of the landmark-mode solve: Adam (b1 0.9, b2 0.999, eps
  1e-8, bias-corrected) on the masked mean squared landmark distance.

All products go through ``precision.mm``; the functions take float32 or
float64 tensors alike.
"""
from __future__ import annotations

import torch

from . import precision

Tensor = torch.Tensor
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ROT_DIM = {"axis_angle": 3}
LEAVES = (("input", "w"), ("input", "b"), ("hidden", "w"), ("hidden", "b"),
          ("trn", "w"), ("trn", "b"), ("rot", "w"), ("rot", "b"))


def _check(cfg: dict) -> None:
    if cfg["motion_type"] != "SE3" or cfg["rotation_format"] != "axis_angle":
        raise ValueError("the reference covers SE3 + axis_angle")


def _linear(gen, shape_w, fan_in, fan_out):
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    w = (torch.rand(shape_w, generator=gen) * 2.0 - 1.0) * limit
    b_limit = 1.0 / fan_in ** 0.5
    b = (torch.rand(shape_w[:-2] + (shape_w[-1],), generator=gen) * 2.0
         - 1.0) * b_limit
    return {"w": w, "b": b}


def init_params(gen: torch.Generator, cfg: dict) -> dict:
    _check(cfg)
    m, w, d = cfg["m"], cfg["width"], cfg["depth"]
    r = ROT_DIM[cfg["rotation_format"]]
    return {"input": _linear(gen, (m, 6, w), 6, w),
            "hidden": _linear(gen, (m, d - 1, w, w), w, w),
            "trn": _linear(gen, (m, w, 3), w, 3),
            "rot": _linear(gen, (m, w, r), w, r)}


def masked_mean(x: Tensor, valid: Tensor) -> Tensor:
    return (torch.where(valid[:, None], x, 0.0).sum(0)
            / valid.sum().clamp_min(1))


def level_warp(p: dict, x: Tensor, level: Tensor, cfg: dict) -> Tensor:
    """One level's warp of x [B, N, 3], each pair at its own level [B];
    p's leaves carry the pair axis."""
    freq = torch.pow(2.0, (level + 1 + cfg["k0"]).to(torch.float32))
    xf = x * freq[:, None, None]
    s, c = torch.sin(xf), torch.cos(xf)
    fea = torch.stack([s[..., 0], c[..., 0], s[..., 1], c[..., 1],
                       s[..., 2], c[..., 2]], dim=-1)
    fea = torch.relu(precision.mm(fea, p["input"]["w"])
                     + p["input"]["b"][:, None, :])
    for i in range(p["hidden"]["w"].shape[1]):
        fea = torch.relu(precision.mm(fea, p["hidden"]["w"][:, i])
                         + p["hidden"]["b"][:, i, None, :])
    scale = cfg["mlp_scale"]
    t = scale * (precision.mm(fea, p["trn"]["w"]) + p["trn"]["b"][:, None])
    r = scale * (precision.mm(fea, p["rot"]["w"]) + p["rot"]["b"][:, None])
    theta = torch.sqrt(torch.clamp_min((r * r).sum(-1, keepdim=True),
                                       1e-12))
    w = r / theta
    wxx = torch.linalg.cross(w, x, dim=-1)
    wdx = (w * x).sum(-1, keepdim=True)
    rx = x + torch.sin(theta) * wxx + (1.0 - torch.cos(theta)) * (w * wdx - x)
    return rx + t


def warp(params: dict, x: Tensor, cfg: dict) -> Tensor:
    """All levels in order, of one pair (params without the pair axis)."""
    for lvl in range(cfg["m"]):
        p = {k: {kk: vv[lvl][None] for kk, vv in v.items()}
             for k, v in params.items()}
        x = level_warp(p, x[None], torch.tensor([lvl], device=x.device),
                       cfg)[0]
    return x


def landmark_level(p_in: dict, lvl: int, x: Tensor, y: Tensor,
                   valid: Tensor, n: int, cfg: dict) -> dict:
    """One level of the landmark-mode solve (``w_cd == 0``) from the
    level's parameters ``p_in`` (no level axis) and its landmark rows ``x``
    (targets ``y``, mask ``valid``), run for the program's iteration count
    ``n``: Adam on the masked mean squared landmark distance; the update of
    the last iteration is withheld where the level stopped before its cap
    (the early stop is a decision that rounding can flip, so the reference
    follows the program's count). Returns the level's parameters, its last
    warp of the rows (what the next level starts from), and its first and
    last losses."""
    mask = valid.to(torch.float32)[:, None]
    count = torch.clamp_min(valid.sum(), 1).to(torch.float32)
    p = {k: {kk: vv[None].clone() for kk, vv in v.items()}
         for k, v in p_in.items()}
    mom = {k: {kk: torch.zeros_like(vv) for kk, vv in v.items()}
           for k, v in p.items()}
    vel = {k: {kk: torch.zeros_like(vv) for kk, vv in v.items()}
           for k, v in p.items()}
    level = torch.tensor([lvl], device=x.device)
    aux, first, last, applied = x, None, None, 0
    for i in range(1, n + 1):
        with torch.enable_grad():
            leaves = {k: {kk: vv.detach().requires_grad_(True)
                          for kk, vv in v.items()} for k, v in p.items()}
            warped = level_warp(leaves, x[None], level, cfg)[0]
            diff = (warped - y) * mask
            loss = (diff * diff).sum() / count
            grads = torch.autograd.grad(
                loss, [leaves[k][kk] for k, kk in LEAVES])
        first = loss.detach() if first is None else first
        last = loss.detach()
        aux = warped.detach()
        if i == n and n < cfg["iters"]:
            break
        applied += 1
        t = float(applied)
        for (k, kk), g in zip(LEAVES, grads):
            m2 = ADAM_B1 * mom[k][kk] + (1 - ADAM_B1) * g
            v2 = ADAM_B2 * vel[k][kk] + (1 - ADAM_B2) * g * g
            upd = (m2 / (1 - ADAM_B1 ** t)) \
                / (torch.sqrt(v2 / (1 - ADAM_B2 ** t)) + ADAM_EPS)
            p[k][kk] = p[k][kk] - cfg["lr"] * upd
            mom[k][kk], vel[k][kk] = m2, v2
    return {"params": {k: {kk: vv[0] for kk, vv in v.items()}
                       for k, v in p.items()},
            "points": aux, "first_loss": float(first),
            "last_loss": float(last)}
