"""Nested dicts of tensors (params, state, optimizer moments) as trees.

Leaves are visited in sorted-key order, the order ``jax.tree`` uses for
dicts, so a sum over leaves adds in the JAX package's order.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]
