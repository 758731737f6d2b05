"""Debugging switches (SURVEY.md §5 race-detection / sanitizer analogue).

Counterpart of ``deformationpyramid_tpu/utils/debug.py``. The reference's
guards are ``torch.autograd.set_detect_anomaly(True)`` (``trainer.py:249``)
and a NaN / Inf gradient filter (``lib/utils.py:103``). The JAX package
switches on ``jax_debug_nans`` and wraps a function with ``checkify``'s
NaN and index checks; here anomaly detection is autograd's own, PyTorch
checks index bounds itself, and :func:`checkified` checks the outputs.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def enable_nan_checks(enable: bool = True) -> None:
    """Raise in the backward pass where a gradient turns NaN, naming the
    forward op that made it (``torch.autograd.set_detect_anomaly``). Slows
    execution; use while debugging diverging solves, as the reference does
    during training."""
    torch.autograd.set_detect_anomaly(enable)


class CheckError:
    """What :func:`checkified` found: ``get()`` is None or the message of
    the first non-finite output; ``throw()`` raises it."""

    def __init__(self, message: str | None = None):
        self.message = message

    def get(self) -> str | None:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def _first_non_finite(tree: Any, path: str = "out") -> str | None:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if (isinstance(tree, torch.Tensor) and tree.is_floating_point()
                and not bool(torch.isfinite(tree).all())):
            return f"non-finite value in {path}"
        return None
    for k, v in items:
        found = _first_non_finite(v, f"{path}[{k!r}]")
        if found is not None:
            return found
    return None


def checkified(fn: Callable) -> Callable:
    """Wrap ``fn`` so that it returns ``(err, out)``: ``err.throw()`` on the
    host raises on the first non-finite floating leaf of ``out`` (nested
    dicts, lists and tuples walked in order), the failure mode of a
    diverging optimizer loop. One host read a leaf."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        return CheckError(_first_non_finite(out)), out

    return wrapped
