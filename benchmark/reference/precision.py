"""Products of the reference, in float32 or one precision below it.

``"f32"``: exact float32 products (the card's TF32 switched off).
``"tf32"``: each operand rounded to TF32's 10-bit mantissa (round to
nearest, ties away), then multiplied and summed in float32, as the card's
TF32 tensor cores do: the control of a float32 configuration. The rounding
is done on the operands, so the control reads the same on the CPU and on
the card.
"""
from __future__ import annotations

import contextlib

import torch

_MODE = ["f32"]


@contextlib.contextmanager
def mode(name: str):
    if name not in ("f32", "tf32"):
        raise ValueError(f"unknown precision {name!r}")
    old = _MODE[0]
    _MODE[0] = name
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        _MODE[0] = old
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def current() -> str:
    return _MODE[0]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (13 low mantissa bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


class _Round(torch.autograd.Function):
    """TF32 rounding whose gradient passes straight through (the rounded
    backward products round their own operands)."""

    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _operand(x: torch.Tensor) -> torch.Tensor:
    if _MODE[0] == "tf32":
        return _Round.apply(x)
    return x


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b at the current precision."""
    return torch.matmul(_operand(a), _operand(b))


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """torch.einsum at the current precision."""
    return torch.einsum(eq, *(_operand(o) for o in ops))
