"""Trees of parameters, grads, states and caches: nested dicts and lists.

The one tree module of the package, in place of ``jax.tree``: dicts and
lists are containers, anything else (a tensor, an array, a tuple) is a leaf,
and None stays None.
"""
from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf-wise over ``tree``; ``rest`` are trees of its
    structure (or with whole subtrees where ``tree`` has a leaf), and ``fn``
    takes one leaf of each."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree):
    """Leaves in ``jax.tree.leaves`` order: dicts by sorted key, lists in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    if tree is None:
        return []
    return [tree]


__all__ = ["tree_map", "tree_leaves"]
