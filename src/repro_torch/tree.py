"""Parameter trees: nested dicts and tuples of tensors, flattened in
sorted-key order for dicts and in position order for tuples (the order
``jax.tree_util`` flattens the reference's trees, so per-leaf key splits
line up leaf for leaf)."""

from __future__ import annotations

from typing import Any, Callable, List

PyTree = Any


def leaves(tree: PyTree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in leaves(t)]
    return [tree]


def leaves_with_paths(tree: PyTree, prefix: tuple = ()) -> List[tuple]:
    """``(keys, leaf)`` in ``leaves`` order, ``keys`` the tuple of dict
    keys and tuple positions that lead to the leaf."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in leaves_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, tuple):
        return [item for i, t in enumerate(tree)
                for item in leaves_with_paths(t, prefix + (i,))]
    return [(prefix, tree)]


def map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:  # noqa: A001
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, tuple):
        return tuple(map(fn, t, *(r[i] for r in rest))
                     for i, t in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like: PyTree, values: List[Any]) -> PyTree:
    """Rebuild ``like``'s structure from ``values`` in ``leaves`` order."""
    it = iter(values)
    out = map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
