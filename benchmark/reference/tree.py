"""``tree_map`` and ``tree_leaves``: frozen copy from
deformationpyramid_tpu_torch/models/pyramid.py at commit
52465dd567ae528633903efcb67c623d9d527dd1."""
from __future__ import annotations


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
