"""Parameter trees: nested dicts of tensors, flattened in sorted-key order
(the order ``jax.tree_util`` flattens the reference's dict-of-dicts, so
per-leaf key splits line up leaf for leaf)."""

from __future__ import annotations

from typing import Any, Callable, List

PyTree = Any


def leaves(tree: PyTree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:  # noqa: A001
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def unflatten(like: PyTree, values: List[Any]) -> PyTree:
    """Rebuild ``like``'s structure from ``values`` in ``leaves`` order."""
    it = iter(values)
    out = map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
