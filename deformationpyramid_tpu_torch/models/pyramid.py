"""Neural Deformation Pyramid — the model core in PyTorch.

Counterpart of ``deformationpyramid_tpu/models/pyramid.py``. All m levels'
parameters are stacked along a leading level axis in a nested dict of
tensors, the JAX package's layout, so that the parity tests compare like
with like::

    {"input": {"w": [m, 6, w], "b": [m, w]},
     "hidden": {"w": [m, d-1, w, w], "b": [m, d-1, w]},
     "rot": {"w": [m, w, rot_dim], ...}, "trn": {...},
     "scale": {...} (Sim3), "nr": {...} (nonrigidity_est)}

Weights are stored [in, out]. Behavioural quirks kept from the reference
(``nets.py``):
* posenc uses the single frequency ``2**(level+1+k0)``, without pi;
* feature order is [sin x, cos x, sin y, cos y, sin z, cos z];
* every head's output is scaled by ``mlp_scale = 1e-3``;
* the Sim3 scale is ``1e-3 * s + 1``;
* the nonrigidity gate is active only at level > 0.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..geometry import rotations as rot

Tensor = torch.Tensor

ROTATION_DIMS = {"euler": 3, "axis_angle": 3, "quaternion": 4, "6D": 6}
MOTIONS = ("SE3", "Sim3", "sflow")


@dataclasses.dataclass(frozen=True)
class NDPConfig:
    """Static pyramid hyperparameters (reference ``config/NDP.yaml``)."""

    m: int = 9                # number of pyramid levels
    k0: int = -8              # base log2 frequency offset
    depth: int = 3            # MLP depth (1 input layer + depth-1 hidden)
    width: int = 128
    rotation_format: str = "axis_angle"
    motion: str = "SE3"
    nonrigidity_est: bool = False
    mlp_scale: float = 1e-3

    def __post_init__(self):
        if self.motion not in MOTIONS:
            raise ValueError(f"unknown motion {self.motion!r}")
        if self.rotation_format not in ROTATION_DIMS:
            raise ValueError(f"unknown rotation format {self.rotation_format!r}")

    @property
    def rot_dim(self) -> int:
        return ROTATION_DIMS[self.rotation_format]


def _linear_init(gen: torch.Generator, shape_w: tuple[int, ...], fan_in: int,
                 fan_out: int) -> dict[str, Tensor]:
    """Xavier-uniform weight + torch-default uniform bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (reference ``nets.py:180-183``)."""
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    w = (torch.rand(shape_w, generator=gen) * 2.0 - 1.0) * limit
    b_limit = 1.0 / fan_in ** 0.5
    b = (torch.rand(shape_w[:-2] + (shape_w[-1],), generator=gen) * 2.0
         - 1.0) * b_limit
    return {"w": w, "b": b}


def init_pyramid_params(gen: torch.Generator, cfg: NDPConfig,
                        device: torch.device | str | None = None
                        ) -> dict[str, Any]:
    """Stacked parameters for all m levels, drawn from a CPU generator so
    that one seed gives the same weights on every device."""
    m, w, d = cfg.m, cfg.width, cfg.depth
    params = {
        "input": _linear_init(gen, (m, 6, w), 6, w),
        "hidden": _linear_init(gen, (m, max(d - 1, 0), w, w), w, w),
        "trn": _linear_init(gen, (m, w, 3), w, 3),
    }
    if cfg.motion in ("SE3", "Sim3"):
        params["rot"] = _linear_init(gen, (m, w, cfg.rot_dim), w, cfg.rot_dim)
    if cfg.motion == "Sim3":
        params["scale"] = _linear_init(gen, (m, w, 1), w, 1)
    if cfg.nonrigidity_est:
        params["nr"] = _linear_init(gen, (m, w, 1), w, 1)
    return tree_map(lambda t: t.to(device), params)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every leaf of a tree of nested dicts and lists (the
    pyramid's tree has dicts only; the landmark model's has lists of
    layers too). Further trees of the same structure give ``fn`` their
    leaves as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree of nested dicts and lists, in the order
    :func:`tree_map` visits them."""
    out: list = []
    tree_map(out.append, tree)
    return out


def _leaves(tree):
    """Leaves in the order of JAX's ``ravel_pytree`` (dict keys sorted,
    lists in index order), so a flat vector here matches the JAX
    solver's. A tuple is a leaf (a shape)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def ravel(tree) -> Tensor:
    """Tree of tensors (nested dicts and lists) -> one flat vector."""
    return torch.cat([leaf.reshape(-1) for leaf in _leaves(tree)])


def unravel(flat: Tensor, shapes) -> Any:
    """Inverse of :func:`ravel`: views of ``flat`` shaped by ``shapes``
    (the same tree with a shape tuple at every leaf)."""
    offset = 0

    def build(node):
        nonlocal offset
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(v) for v in node]
        size = int(np.prod(node, dtype=np.int64))
        leaf = flat[offset:offset + size].view(node)
        offset += size
        return leaf

    out = build(shapes)
    if offset != flat.numel():
        raise ValueError(f"flat vector has {flat.numel()} values, the "
                         f"shapes need {offset}")
    return out


def level_shapes(cfg: NDPConfig) -> dict[str, Any]:
    """Shapes of one level's parameters (the leaves of
    :func:`init_pyramid_params` without the level axis)."""
    w, nh = cfg.width, max(cfg.depth - 1, 0)
    shapes = {
        "input": {"w": (6, w), "b": (w,)},
        "hidden": {"w": (nh, w, w), "b": (nh, w)},
        "trn": {"w": (w, 3), "b": (3,)},
    }
    if cfg.motion in ("SE3", "Sim3"):
        shapes["rot"] = {"w": (w, cfg.rot_dim), "b": (cfg.rot_dim,)}
    if cfg.motion == "Sim3":
        shapes["scale"] = {"w": (w, 1), "b": (1,)}
    if cfg.nonrigidity_est:
        shapes["nr"] = {"w": (w, 1), "b": (1,)}
    return shapes


def params_from_numpy(tree: dict, device: torch.device | str | None = None
                      ) -> dict[str, Any]:
    """The JAX package's parameter tree (nested dicts and lists; leaves as
    numpy arrays, or anything ``np.asarray`` takes) -> the port's float32
    tensors, values unchanged. Buffers that are no weights (a KPConv's
    ``kernel_points``) are leaves like any other."""
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(device), tree)


def params_to_numpy(tree: dict) -> dict[str, Any]:
    """Inverse of :func:`params_from_numpy`."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def level_params(params: dict[str, Any], level: int) -> dict[str, Any]:
    """Slice one level out of the stacked params."""
    return tree_map(lambda p: p[level], params)


def posenc(x: Tensor, level: int, k0: int) -> Tensor:
    """Single-frequency sin/cos encoding, freq = 2**(level+1+k0)."""
    freq = 2.0 ** (level + 1 + k0)
    s, c = torch.sin(x * freq), torch.cos(x * freq)
    return torch.stack([s[..., 0], c[..., 0], s[..., 1], c[..., 1],
                        s[..., 2], c[..., 2]], dim=-1)


def _head(fea: Tensor, p: dict[str, Tensor]) -> Tensor:
    return fea @ p["w"] + p["b"]


def level_features(p: dict[str, Any], x: Tensor, level: int,
                   cfg: NDPConfig) -> Tensor:
    """Shared trunk: posenc -> input linear+ReLU -> hidden MLP."""
    fea = torch.relu(_head(posenc(x, level, cfg.k0), p["input"]))
    for i in range(p["hidden"]["w"].shape[0]):
        fea = torch.relu(fea @ p["hidden"]["w"][i] + p["hidden"]["b"][i])
    return fea


def rotation_from_features(r: Tensor, fmt: str) -> Tensor:
    """Head output [..., rot_dim] (already mlp_scaled) -> [..., 3, 3]."""
    if fmt == "euler":
        return rot.euler_to_SO3(r)
    if fmt == "axis_angle":
        return rot.axis_angle_to_SO3(r)
    if fmt == "quaternion":
        return rot.quaternion_to_SO3(rot.normalize_quaternion(r))
    if fmt == "6D":
        return rot.sixd_to_SO3(r)
    raise ValueError(fmt)


def level_warp(p: dict[str, Any], x: Tensor, level: int,
               cfg: NDPConfig) -> tuple[Tensor, Tensor | None]:
    """Warp points [N, 3] through one pyramid level.

    Returns (warped [N, 3], nonrigidity [N] or None), as
    ``NDPLayer.forward`` (``nets.py:111-140``).
    """
    fea = level_features(p, x, level, cfg)
    t = cfg.mlp_scale * _head(fea, p["trn"])

    if cfg.motion == "sflow":
        x_ = x + t
    elif cfg.rotation_format == "axis_angle":
        rx = rot.rotate_axis_angle(cfg.mlp_scale * _head(fea, p["rot"]), x)
        if cfg.motion == "Sim3":
            s = cfg.mlp_scale * _head(fea, p["scale"]) + 1.0
            x_ = s * rx + t
        else:
            x_ = rx + t
    else:
        R = rotation_from_features(cfg.mlp_scale * _head(fea, p["rot"]),
                                   cfg.rotation_format)
        rx = rot.apply_rotation(R, x)
        if cfg.motion == "Sim3":
            s = cfg.mlp_scale * _head(fea, p["scale"]) + 1.0
            x_ = s * rx + t
        else:
            x_ = rx + t

    nonrigidity = None
    if cfg.nonrigidity_est:
        nr = torch.sigmoid(cfg.mlp_scale * _head(fea, p["nr"]))[..., 0]
        if level > 0:  # level 0 never gates (reference has no branch there)
            x_ = x + nr[..., None] * (x_ - x)
            nonrigidity = nr
        else:
            nonrigidity = torch.ones_like(nr)
    return x_, nonrigidity


def warp_numpy(params, x, cfg: NDPConfig) -> np.ndarray:
    """Host-side (numpy) full-pyramid warp, mirroring :func:`warp`: what the
    evaluation's ``--host-metrics`` mode runs on the fetched parameters.
    SE3 / Sim3 / sflow with axis_angle only, no nonrigidity head. ``params``
    is the stacked tree with numpy leaves (:func:`params_to_numpy`)."""
    if cfg.rotation_format != "axis_angle" or cfg.nonrigidity_est:
        raise ValueError("warp_numpy covers axis_angle without the "
                         "nonrigidity head only")
    x = np.asarray(x, np.float32)
    p = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
         for k, v in params.items()}
    for lvl in range(cfg.m):
        freq = np.float32(2.0 ** (lvl + 1 + cfg.k0))
        s, c = np.sin(x * freq), np.cos(x * freq)
        fea = np.stack([s[:, 0], c[:, 0], s[:, 1], c[:, 1],
                        s[:, 2], c[:, 2]], axis=-1)
        fea = np.maximum(fea @ p["input"]["w"][lvl] + p["input"]["b"][lvl], 0.0)
        for h in range(p["hidden"]["w"].shape[1]):
            fea = np.maximum(fea @ p["hidden"]["w"][lvl, h]
                             + p["hidden"]["b"][lvl, h], 0.0)
        t = cfg.mlp_scale * (fea @ p["trn"]["w"][lvl] + p["trn"]["b"][lvl])
        if cfg.motion == "sflow":
            x = x + t
            continue
        r = cfg.mlp_scale * (fea @ p["rot"]["w"][lvl] + p["rot"]["b"][lvl])
        theta = np.sqrt(np.maximum((r * r).sum(-1, keepdims=True), 1e-12))
        w = r / theta
        sn, cs = np.sin(theta), np.cos(theta)
        wxx = np.cross(w, x)
        wdx = (w * x).sum(-1, keepdims=True)
        rx = x + sn * wxx + (1.0 - cs) * (w * wdx - x)
        if cfg.motion == "Sim3":
            sc = cfg.mlp_scale * (fea @ p["scale"]["w"][lvl]
                                  + p["scale"]["b"][lvl]) + 1.0
            x = sc * rx + t
        else:
            x = rx + t
    return x


def warp(params: dict[str, Any], x: Tensor, cfg: NDPConfig,
         max_level: int | None = None, min_level: int = 0
         ) -> tuple[Tensor, Tensor | None]:
    """Compose the warps of levels [min_level, max_level] in order
    (``Deformation_Pyramid.warp``, ``nets.py:36-48``); returns the final
    points and the last level's nonrigidity map."""
    if max_level is None:
        max_level = cfg.m - 1
    if not 0 <= min_level <= max_level < cfg.m:
        raise ValueError(f"bad level range [{min_level}, {max_level}]")
    nr = None
    for lvl in range(min_level, max_level + 1):
        x, nr = level_warp(level_params(params, lvl), x, lvl, cfg)
    return x, nr
