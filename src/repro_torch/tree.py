"""Nested-dict parameter trees, in the leaf order of `jax.tree` (keys
sorted at every level), so flat layouts match the reference exactly."""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def unflatten_like(tree, flat: List[Any]):
    """Rebuild ``tree``'s structure from leaves in `leaves` order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(tree)


def map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def size(tree) -> int:
    return sum(int(x.numel()) for x in leaves(tree))
