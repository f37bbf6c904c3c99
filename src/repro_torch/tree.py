"""Parameter trees: nested dicts and lists of tensors (the counterpart of a
JAX pytree of params). Leaves are visited in the order of
``jax.tree_util.tree_leaves``: dict keys sorted, lists in order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves(tree) -> List[Any]:
    """The tree's leaves, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def paths(tree, prefix: Tuple = ()) -> List[Tuple]:
    """The key path of each leaf, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree)
                for q in paths(v, prefix + (i,))]
    return [prefix]


def map(fn: Callable, tree, *rest):
    """A tree of ``fn(leaf, *leaves of rest)`` with `tree`'s structure."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(tree, new_leaves) -> Any:
    """A tree with `tree`'s structure and `new_leaves` in ``leaves`` order."""
    it = iter(new_leaves)

    def take(t):
        if isinstance(t, dict):
            return {k: take(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(take(v) for v in t)
        return next(it)

    out = take(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
