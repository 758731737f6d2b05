"""Rotation parameterizations as plain PyTorch functions.

Counterpart of ``deformationpyramid_tpu/geometry/rotations.py`` (reference
semantics ``model/rigid_body.py:5-119``). Rotations are ``[..., 3, 3]``
matrices acting on column vectors; every norm goes through ``_safe_norm``
so a zero input gives a finite value and gradient.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

_EPS = 1e-12


def _safe_norm(x: Tensor, dim: int = -1, keepdim: bool = True) -> Tensor:
    """L2 norm with a tiny floor so the gradient at 0 is finite."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp_min(sq, _EPS))


def skew(w: Tensor) -> Tensor:
    """[..., 3] axis vector -> [..., 3, 3] skew-symmetric matrix."""
    zero = torch.zeros_like(w[..., 0])
    rows = torch.stack([
        zero, -w[..., 2], w[..., 1],
        w[..., 2], zero, -w[..., 0],
        -w[..., 1], w[..., 0], zero,
    ], dim=-1)
    return rows.reshape(w.shape[:-1] + (3, 3))


def exp_so3(w: Tensor, theta: Tensor) -> Tensor:
    """Rodrigues' formula: unit axis ``w`` [..., 3], angle ``theta`` [..., 1]."""
    theta = theta[..., None]
    W = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(theta) * W + (1.0 - torch.cos(theta)) * (W @ W)


def exp_se3(w: Tensor, v: Tensor, theta: Tensor) -> tuple[Tensor, Tensor]:
    """Screw motion exponential (the Nerfies baseline's warp): unit
    rotation axis ``w`` and translation direction ``v`` [..., 3], ``theta``
    [..., 1]. Returns (R [..., 3, 3], t [..., 3, 1]), as the reference's
    ``model/rigid_body.py:97-111``."""
    theta = theta[..., None]
    W = skew(w)
    WW = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    R = eye + torch.sin(theta) * W + (1.0 - torch.cos(theta)) * WW
    p = eye + (1.0 - torch.cos(theta)) * W + (theta - torch.sin(theta)) * WW
    return R, p @ v[..., None]


def axis_angle_to_SO3(r: Tensor) -> Tensor:
    """Unnormalized axis-angle vector [..., 3] -> rotation matrix."""
    theta = _safe_norm(r)
    return exp_so3(r / theta, theta)


def rotate_axis_angle(r: Tensor, x: Tensor) -> Tensor:
    """Apply exp(skew(r)) to x without building [..., 3, 3] matrices.

    R x = x + sin(t) (w x x) + (1 - cos(t)) (w (w.x) - x), t = |r|, w = r/t.
    """
    theta = _safe_norm(r)
    w = r / theta
    s, c = torch.sin(theta), torch.cos(theta)
    wxx = torch.linalg.cross(w, x, dim=-1)
    wdx = torch.sum(w * x, dim=-1, keepdim=True)
    return x + s * wxx + (1.0 - c) * (w * wdx - x)


def rotate_axis_angle_t(r: Tensor, x: Tensor) -> Tensor:
    """:func:`rotate_axis_angle` in the JAX package's transposed [3, N]
    layout (r, x [3, N])."""
    return rotate_axis_angle(r.T, x.T).T


def euler_to_SO3(euler: Tensor, convention: str = "XYZ") -> Tensor:
    """Euler angles [..., 3] -> rotation, R = Rx @ Ry @ Rz for "XYZ"."""

    def axis_rot(axis: str, angle: Tensor) -> Tensor:
        c, s = torch.cos(angle), torch.sin(angle)
        one, zero = torch.ones_like(angle), torch.zeros_like(angle)
        if axis == "X":
            flat = (one, zero, zero, zero, c, -s, zero, s, c)
        elif axis == "Y":
            flat = (c, zero, s, zero, one, zero, -s, zero, c)
        elif axis == "Z":
            flat = (c, -s, zero, s, c, zero, zero, zero, one)
        else:
            raise ValueError(f"bad axis {axis!r}")
        return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))

    if len(convention) != 3 or any(a not in "XYZ" for a in convention):
        raise ValueError(f"bad convention {convention!r}")
    mats = [axis_rot(a, euler[..., i]) for i, a in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def _copysign(a: Tensor, b: Tensor) -> Tensor:
    """Magnitude of ``a`` with the sign flipped where signs of a/b differ
    (not IEEE copysign: a zero ``b`` keeps ``a`` untouched)."""
    return torch.where((a < 0) != (b < 0), -a, a)


def quaternion_to_SO3(q: Tensor) -> Tensor:
    """(possibly unnormalized) quaternion [..., 4] (r,i,j,k) -> rotation."""
    r, i, j, k = q.unbind(-1)
    two_s = 2.0 / torch.clamp_min(torch.sum(q * q, dim=-1), _EPS)
    o = torch.stack([
        1 - two_s * (j * j + k * k),
        two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r),
        1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r),
        two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j),
    ], dim=-1)
    return o.reshape(q.shape[:-1] + (3, 3))


def normalize_quaternion(q: Tensor) -> Tensor:
    """Divide by ``copysign(|q|, q_r)`` so the scalar part stays
    non-negative (reference ``model/nets.py:154-157``)."""
    s = torch.sum(q * q, dim=-1)
    denom = _copysign(torch.sqrt(torch.clamp_min(s, _EPS)), q[..., 0])
    return q / denom[..., None]


def sixd_to_SO3(d6: Tensor) -> Tensor:
    """6D rotation representation -> rotation matrix (Gram-Schmidt rows)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / _safe_norm(a1)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / _safe_norm(b2)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def apply_rotation(R: Tensor, x: Tensor) -> Tensor:
    """Per-point rotation: R [..., 3, 3] @ x [..., 3] -> [..., 3]."""
    return torch.einsum("...ij,...j->...i", R, x)
