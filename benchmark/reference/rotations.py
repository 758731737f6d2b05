"""``euler_to_SO3``: frozen copy from
deformationpyramid_tpu_torch/geometry/rotations.py at commit
52465dd567ae528633903efcb67c623d9d527dd1."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


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
