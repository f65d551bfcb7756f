"""Nested-dict parameter trees in the reference's leaf order.

JAX flattens a dict in sorted key order, and the reference's optimizer
(``global_norm``'s sum) and checkpoint store (leaf names, page ids, segment
contents) follow that order; these helpers give the port's nested dicts of
tensors the same order.  A leaf is anything that is not a dict.
"""

from __future__ import annotations

from typing import Any, Callable


def leaf_paths(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """(key path, leaf) of every leaf, dict keys in sorted order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += leaf_paths(tree[k], prefix + (k,))
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaf_paths(tree)]


def unflatten_like(tree: Any, new_leaves: list) -> Any:
    """A tree of ``tree``'s structure holding ``new_leaves`` in
    :func:`leaf_paths` order."""
    it = iter(new_leaves)

    def build(node):
        if not isinstance(node, dict):
            return next(it)
        return {k: build(node[k]) for k in sorted(node)}
    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
