"""Plain reference of NDP's Sim(3) shape transfer (NDP, arXiv 2205.12796;
the reference program's ``shape_transfer.py``, ``model/nets.py``,
``model/registration.py`` and ``model/loss.py``).

* the initial pyramid: as ``ndp.init_params``, with the Sim3 scale head
  (width -> 1) drawn last, after the rotation head (3 Euler angles);
* one level's warp (``nets.py`` ``NDPLayer``): the posenc, the ReLU MLP
  and the heads scaled by ``mlp_scale`` of ``ndp.level_warp``; the
  rotation from the Euler angles, R = Rx Ry Rz (``reference/rotations.py``
  ``euler_to_SO3``), applied to each point; the Sim3 scale ``mlp_scale *
  s + 1``; the warp ``s * (R x) + t``;
* the whole-pyramid warp: every level in order;
* the surface samples (``shape_transfer.py``'s Open3D
  ``sample_points_uniformly``): a face drawn with probability its area
  over the mesh's, then a point uniform on it, ``a + sqrt(u1) (b - a) +
  sqrt(u1) u2 (c - b)`` (Osada et al., "Shape distributions", 2002);
* the chamfer objective of a level without landmarks
  (``registration.py``, ``trunc = 1e9``): the mean over the source rows
  of the distance to the nearest target row, plus the mean over the
  target rows of the distance to the nearest warped row, a row whose
  squared distance reaches ``trunc`` left out (``loss.py``);
* one level of Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected, fresh
  state a level) with the three-way early stop of ``registration.py``:
  stop before the step when the loss is under ``loss_eps``, or when the
  loss has moved by less than ``break_threshold_ratio`` of the last
  stepped loss ``max_break_count`` times in all; the points handed to the
  next level are the warp of the last evaluation, before its step.

Departures, each the port's and the JAX package's as well: the nearest
rows are found by brute force (in float64, ``nearest``), not by a k-d
tree, and a tie takes the first index; the root of a squared distance is
floored at 1e-16 (``_FLOOR``), where the reference program would give an
infinite gradient at a zero distance. Adam's bias corrections are computed in double, as
``torch.optim.Adam`` computes them; the port computes them in float32, as
optax does, which parts from them by up to ~6e-5 of the first steps'
second-moment correction. The samples are drawn with numpy's generator in
the order the port draws them (the faces, then every ``u1``, then every
``u2``), with the areas in the vertices' float32, so that the two can be
compared point by point; Open3D draws with a generator of its own. The products go through ``precision`` (the rotation
of each point too), so the functions take float32 or float64 tensors
alike and the control rounds them to TF32. No subsampling: the demo solves
every level on all of its samples.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ndp, precision
from .rotations import euler_to_SO3

Tensor = torch.Tensor
LEAVES = ndp.LEAVES + (("scale", "w"), ("scale", "b"))
_FLOOR = 1e-16


def _check(cfg: dict) -> None:
    if cfg["motion_type"] != "Sim3" or cfg["rotation_format"] != "euler":
        raise ValueError("the reference covers Sim3 + euler")


def init_params(gen: torch.Generator, cfg: dict) -> dict:
    """Stacked parameters of every level, drawn from ``gen``."""
    _check(cfg)
    m, w, d = cfg["m"], cfg["width"], cfg["depth"]
    return {"input": ndp._linear(gen, (m, 6, w), 6, w),
            "hidden": ndp._linear(gen, (m, d - 1, w, w), w, w),
            "trn": ndp._linear(gen, (m, w, 3), w, 3),
            "rot": ndp._linear(gen, (m, w, 3), w, 3),
            "scale": ndp._linear(gen, (m, w, 1), w, 1)}


def level(params: dict, lvl: int) -> dict:
    """One level's parameters out of the stacked tree."""
    return {k: {kk: vv[lvl] for kk, vv in v.items()}
            for k, v in params.items()}


def level_warp(p: dict, x: Tensor, lvl: int, cfg: dict) -> Tensor:
    """One level's warp of x [N, 3]; p without the level axis."""
    _check(cfg)
    freq = 2.0 ** (lvl + 1 + cfg["k0"])
    xf = x * freq
    s, c = torch.sin(xf), torch.cos(xf)
    fea = torch.stack([s[:, 0], c[:, 0], s[:, 1], c[:, 1],
                       s[:, 2], c[:, 2]], dim=-1)
    fea = torch.relu(precision.mm(fea, p["input"]["w"]) + p["input"]["b"])
    for i in range(p["hidden"]["w"].shape[0]):
        fea = torch.relu(precision.mm(fea, p["hidden"]["w"][i])
                         + p["hidden"]["b"][i])
    k = cfg["mlp_scale"]
    t = k * (precision.mm(fea, p["trn"]["w"]) + p["trn"]["b"])
    angles = k * (precision.mm(fea, p["rot"]["w"]) + p["rot"]["b"])
    scale = k * (precision.mm(fea, p["scale"]["w"]) + p["scale"]["b"]) + 1.0
    rx = precision.einsum("nij,nj->ni", euler_to_SO3(angles), x)
    return scale * rx + t


def warp(params: dict, x: Tensor, cfg: dict) -> Tensor:
    """Every level in order (stacked params)."""
    for lvl in range(cfg["m"]):
        x = level_warp(level(params, lvl), x, lvl, cfg)
    return x


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   seed: int) -> np.ndarray:
    """``n`` points [n, 3] (float32) uniform by area on the triangles
    ``faces`` of ``verts``, drawn from ``seed``."""
    a, b, c = (verts[faces[:, i]] for i in range(3))
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    rng = np.random.default_rng(seed)
    face = rng.choice(len(faces), size=n, p=area / area.sum())
    u1 = np.sqrt(rng.random(n))[:, None]
    u2 = rng.random(n)[:, None]
    a, b, c = (x[face].astype(np.float64) for x in (a, b, c))
    return (a + u1 * (b - a) + u1 * u2 * (c - b)).astype(np.float32)


def nearest(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """The index of the nearest row of ``b`` for each row of ``a``, and of
    ``a`` for each row of ``b``: squared distances in float64 by the
    product form (an error of ~1e-16 on points of size ~1, finer than the
    rounding of either precision's differences), the first index of a
    tie; no gradient."""
    with torch.no_grad():
        a, b = a.double(), b.double()
        d = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] \
            - 2.0 * (a @ b.T)
        return d.argmin(1), d.argmin(0)


def _root_mean(sq: Tensor, trunc: float) -> Tensor:
    keep = sq < trunc
    root = torch.sqrt(torch.where(keep, torch.clamp_min(sq, _FLOOR), 1.0))
    return torch.where(keep, root, 0.0).sum() / sq.shape[0]


def chamfer(w: Tensor, y: Tensor, trunc: float) -> Tensor:
    """The truncated chamfer of the warped rows ``w`` against the target
    ``y``: differentiable in ``w`` (the nearest rows held fixed)."""
    to_y, to_w = nearest(w, y)
    sq_w = ((w - y[to_y]) ** 2).sum(-1)
    sq_y = ((y - w[to_w]) ** 2).sum(-1)
    return _root_mean(sq_w, trunc) + _root_mean(sq_y, trunc)


def _flat(p: dict) -> Tensor:
    return torch.cat([p[k][kk].reshape(-1) for k, kk in LEAVES])


def _leaves(flat: Tensor, like: dict) -> dict:
    """Views of ``flat`` shaped as the leaves of ``like``."""
    out, at = {}, 0
    for k, kk in LEAVES:
        shape = like[k][kk].shape
        size = like[k][kk].numel()
        out.setdefault(k, {})[kk] = flat[at:at + size].view(shape)
        at += size
    return out


def chamfer_level(p_in: dict, lvl: int, x: Tensor, y: Tensor, cfg: dict,
                  n: int | None = None) -> dict:
    """One chamfer-mode level from its parameters ``p_in`` (no level axis)
    and points ``x``, against the target ``y``. With ``n`` None the level
    runs its own early stop; with ``n`` (the program's iteration count,
    since the early stop is a decision that rounding can flip) it runs
    ``n`` iterations and withholds the last step where ``n`` is under the
    cap, as the stop did. Adam runs on the level's values laid end to end
    (the same arithmetic value by value). Returns the parameters, the
    points handed on, the first and last losses and the iterations."""
    _check(cfg)
    flat = _flat(p_in).detach().clone()
    mom = torch.zeros_like(flat)
    vel = torch.zeros_like(flat)
    trunc = cfg["trunc_chamfer"]
    cap = cfg["iters"] if n is None else n
    aux, first, last, applied, counter = x, None, None, 0, 0
    loss_prev = torch.tensor(1e6, dtype=x.dtype, device=x.device)
    it = 0
    # with ``n`` given nothing is read on the host until the level is over
    for it in range(1, cap + 1):
        with torch.enable_grad():
            f = flat.requires_grad_(True)
            warped = level_warp(_leaves(f, p_in), x, lvl, cfg)
            loss = chamfer(warped, y, trunc)
            (g,) = torch.autograd.grad(loss, f)
        flat = flat.detach()
        loss = loss.detach()
        first = loss if first is None else first
        last = loss
        aux = warped.detach()
        if n is None:
            # the stop's arithmetic in the points' precision, as the
            # program's
            counter += bool(torch.abs(loss_prev - loss)
                            < loss_prev * cfg["break_threshold_ratio"])
            if float(loss) < cfg["loss_eps"] \
                    or counter >= cfg["max_break_count"]:
                break
        elif it == n and n < cfg["iters"]:
            break
        loss_prev = loss
        applied += 1
        t = float(applied)
        mom = ndp.ADAM_B1 * mom + (1 - ndp.ADAM_B1) * g
        vel = ndp.ADAM_B2 * vel + (1 - ndp.ADAM_B2) * g * g
        flat = flat - cfg["lr"] * ((mom / (1 - ndp.ADAM_B1 ** t))
                                   / (torch.sqrt(vel / (1 - ndp.ADAM_B2 ** t))
                                      + ndp.ADAM_EPS))
    return {"params": _leaves(flat, p_in), "points": aux,
            "first_loss": float(first), "last_loss": float(last),
            "iters": it}


def solve(params: dict, x: Tensor, y: Tensor, cfg: dict) -> tuple[dict, dict]:
    """Every level in order on the centred samples ``x`` against ``y``,
    each with its own early stop. Returns the final stacked parameters and
    {"iters": [m], "loss": [m]} (each level's last loss)."""
    out, iters, losses = [], [], []
    for lvl in range(cfg["m"]):
        r = chamfer_level(level(params, lvl), lvl, x, y, cfg)
        out.append(r["params"])
        x = r["points"]
        iters.append(r["iters"])
        losses.append(r["last_loss"])
    final = {k: {kk: torch.stack([o[k][kk] for o in out]) for kk in v}
             for k, v in out[0].items()}
    return final, {"iters": iters, "loss": losses}
