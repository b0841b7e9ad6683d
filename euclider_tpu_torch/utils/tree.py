"""Trees of tensors: the port's parameter structures (``InverseParams``,
``SceneTables`` with its texture tuple, ``CameraParams``, dicts, tuples and
lists) flattened to their leaves and rebuilt.

The leaves come in the order ``jax.tree.leaves`` gives for the JAX
package's same structure: a NamedTuple's fields and a tuple's items in
order, a dict's values by sorted key, ``None`` no leaf, anything else one
leaf.  ``utils/checkpointing.py`` stores them in that order, and
``parallel/`` sums and broadcasts them.
"""
from __future__ import annotations

from typing import Any, Iterator


def leaves(tree: Any) -> list:
    """The leaves of ``tree``, in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def unflatten(like: Any, flat) -> Any:
    """A tree shaped like ``like`` holding the leaves ``flat`` (in
    ``leaves`` order)."""
    it = iter(flat)
    out = _build(like, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


_END = object()


def _build(like: Any, it: Iterator) -> Any:
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: _build(like[k], it) for k in sorted(like)}
        return type(like)((k, vals[k]) for k in like)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_build(x, it) for x in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_build(x, it) for x in like)
    leaf = next(it, _END)
    if leaf is _END:
        raise ValueError("fewer leaves than the tree holds")
    return leaf
