"""YAML config system with attribute access and the ``!join`` tag (a copy
of ``deformationpyramid_tpu/utils/config.py``, which cannot be imported
without importing JAX).

Replaces the reference's EasyDict+yaml loading (``eval_nolearned.py:17-40``,
``config/*.yaml``): same on-disk format, including the custom ``!join``
constructor that builds experiment names from anchored values, and nested
config files referenced by path.
"""
from __future__ import annotations

import yaml


class AttrDict(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, d: dict | None = None, **kw):
        super().__init__()
        for k, v in {**(d or {}), **kw}.items():
            self[k] = v

    def __setitem__(self, k, v):
        if isinstance(v, dict) and not isinstance(v, AttrDict):
            v = AttrDict(v)
        elif isinstance(v, (list, tuple)):
            v = type(v)(AttrDict(x) if isinstance(x, dict) and not isinstance(x, AttrDict)
                        else x for x in v)
        super().__setitem__(k, v)

    __setattr__ = __setitem__

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


def _join_constructor(loader: yaml.Loader, node: yaml.Node) -> str:
    seq = loader.construct_sequence(node)
    return "_".join(str(i) for i in seq)


def _make_loader() -> type[yaml.Loader]:
    class Loader(yaml.Loader):
        pass

    Loader.add_constructor("!join", _join_constructor)
    return Loader


def load_config(path: str, overrides: dict | None = None) -> AttrDict:
    with open(path) as f:
        cfg = yaml.load(f, Loader=_make_loader())
    cfg = AttrDict(cfg or {})
    for k, v in (overrides or {}).items():
        cfg[k] = v
    return cfg

