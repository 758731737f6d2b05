"""Parameter-tree checkpointing (npz flat format + metadata).

Counterpart of ``deformationpyramid_tpu/utils/checkpoint.py`` (reference
``correspondence/lib/trainer.py:68-108``): trees of nested dicts and lists
with tensor leaves, saved under '/'-joined key paths, plus a metadata
record for the trainers' best-metric bookkeeping. The file format is the
JAX package's, so a checkpoint written by either loads in the other (its
loader skips every ``__``-prefixed record; the port writes none but
``__meta__``). The JAX package's orbax backend is not ported.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None or isinstance(tree, (str, bool, int, float)):
        out[prefix[:-1] + ".__scalar__"] = np.asarray(json.dumps(tree))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save_pytree(path: str, tree: Any, meta: dict | None = None) -> None:
    flat = _flatten(tree)
    if meta:
        flat["__meta__"] = np.asarray(json.dumps(meta))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_pytree(path: str, like: Any,
                device: torch.device | str | None = None) -> Any:
    """Load into the structure of ``like`` (shapes validated). Tensors go
    to ``device``; by default each goes where its counterpart in ``like``
    lies (the CPU where that is no tensor)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files if not k.startswith("__")}

    def rebuild(tree: Any, prefix: str = ""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}{i}/")
                              for i, v in enumerate(tree))
        key = prefix[:-1]
        skey = key + ".__scalar__"
        if skey in flat:
            return json.loads(str(flat[skey]))
        arr = flat[key]
        if hasattr(tree, "shape") and tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(tree.shape)}")
        where = device if device is not None else (
            tree.device if isinstance(tree, torch.Tensor) else "cpu")
        return torch.from_numpy(np.array(arr)).to(where)

    return rebuild(like)


def load_meta(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        if "__meta__" in z.files:
            return json.loads(str(z["__meta__"]))
    return {}
