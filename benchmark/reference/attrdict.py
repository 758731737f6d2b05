"""``AttrDict``: frozen copy from deformationpyramid_tpu_torch/utils/config.py
at commit 52465dd567ae528633903efcb67c623d9d527dd1."""
from __future__ import annotations


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
