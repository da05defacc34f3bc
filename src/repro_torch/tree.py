"""Nested dicts of tensors (the port's params, grads and optimizer moments)
as flat lists: the counterpart of ``jax.tree`` for the one tree shape the
port uses.  Leaves are visited in sorted key order, as ``jax.tree``
flattens dicts."""
from __future__ import annotations

from typing import Callable, List, Tuple


def paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, ...]]:
    """Key paths of every leaf, in sorted key order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k], prefix + (k,))]
    return [prefix]


def leaves(tree) -> list:
    """The leaves, in :func:`paths` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def unflatten(keys: List[Tuple[str, ...]], values) -> dict:
    """Rebuild the nesting of ``keys`` (from :func:`paths`) over
    ``values``."""
    out: dict = {}
    for path, val in zip(keys, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = val
    return out


def map_tree(fn: Callable, tree, *rest):
    """``fn`` applied leafwise over ``tree`` and trees of the same
    nesting."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)
