"""Weights of the landmark model, made on the card from the seed.

The tree (its leaves, shapes and per-leaf scales) is that of the
reference's frozen initialiser (``reference/match``), which is the
program's layout. Its uniform draws come from one ``torch.rand`` call of a
``torch.Generator`` on the card, handed out leaf by leaf as views of that
one buffer; the initialiser's own arithmetic (scaling, the layer norms'
ones and zeros, the kernel dispositions) then runs as it is written. The
same tree goes to the program and to the reference.
"""
from __future__ import annotations

import contextlib

import torch

from .reference.match.landmark import LandmarkConfig
from .reference.match.outlier_rejection import init_neco
from .reference.match.pipeline import init_matcher
from .reference.tree import tree_map


@contextlib.contextmanager
def _draws(source):
    """``torch.rand(shape, generator=...)`` served by ``source(shape)``."""
    real = torch.rand

    def rand(*size, generator=None, **kw):
        if len(size) == 1 and isinstance(size[0], (tuple, list, torch.Size)):
            size = tuple(size[0])
        return source(tuple(int(s) for s in size))

    torch.rand = rand
    try:
        yield
    finally:
        torch.rand = real


def _init(cfg: LandmarkConfig) -> dict:
    return {"matcher": init_matcher(None, cfg.matcher),
            "neco": init_neco(None, cfg.neco)}


def landmark_weights(cfg: LandmarkConfig, seed: int,
                     device: torch.device) -> dict:
    """The landmark model's weights for ``seed`` on ``device``: the first
    pass counts the draws on the meta device, the second serves them from
    one buffer drawn on ``device``."""
    sizes: list[tuple[int, ...]] = []

    def count(shape):
        sizes.append(shape)
        return torch.empty(shape, device="meta")

    with _draws(count):
        _init(cfg)
    total = sum(int(torch.Size(s).numel()) for s in sizes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device)
    offset = [0]

    def serve(shape):
        n = int(torch.Size(shape).numel())
        out = flat[offset[0]:offset[0] + n].view(shape)
        offset[0] += n
        return out

    with _draws(serve):
        params = _init(cfg)
    return tree_map(lambda t: t.to(device).contiguous(), params)


def n_values(params: dict) -> int:
    out = [0]
    tree_map(lambda t: out.__setitem__(0, out[0] + t.numel()), params)
    return out[0]
