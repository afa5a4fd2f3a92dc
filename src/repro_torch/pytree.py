"""Nested dicts and lists of tensors, walked in the reference's leaf order.

``jax.tree.flatten`` visits a dict's keys sorted and a list's items in
order; ``leaves`` and ``from_leaves`` do the same, so that the ``i``-th leaf
here is the reference's ``i``-th leaf. The LM's flat parameter vector
(``coding.flatten_pytree``) is laid out in this order on both sides.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["leaves", "from_leaves", "map_tree"]


def leaves(tree: Any) -> list:
    """The leaves of ``tree``: dict values by sorted key, list and tuple
    items in order, anything else is a leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in leaves(v)]
    return [tree]


def from_leaves(skeleton: Any, values: list) -> Any:
    """A tree of ``skeleton``'s structure holding ``values`` in ``leaves``'
    order."""
    it = iter(values)
    out = _rebuild(skeleton, it)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def _rebuild(skeleton: Any, it: Iterator) -> Any:
    if isinstance(skeleton, dict):
        built = {k: _rebuild(skeleton[k], it) for k in sorted(skeleton)}
        return {k: built[k] for k in skeleton}  # the skeleton's own key order
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_rebuild(v, it) for v in skeleton)
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer values than the tree has leaves") from None


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to trees of one structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)
