"""Nested-tuple, dict and dataclass trees of tensors: map, leaves, rebuild.

The one helper every carry site uses: a recurrent carry is ``(c, h)`` for the
LSTM core and ``(valid, ((k, v), ...))`` for the transformer core, and the
rollout's chunks, the ring's store, the device actor's state and the serve
engine's carry slots are trees of it. ``tree_leaves`` walks tuples in order
and dicts and dataclasses in field order; on a tuple-only tree (a carry)
that is the reference's tree-leaf order, so leaf ``i`` names the same
tensor in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Mapping


def tree_map(fn: Callable[..., Any], *trees: Any) -> Any:
    """``fn`` over the leaves of nested dicts and tuples of one structure."""
    if isinstance(trees[0], Mapping):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], tuple):
        return tuple(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of nested dataclasses, dicts and tuples, in order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [leaf for f in dataclasses.fields(tree) for leaf in tree_leaves(getattr(tree, f.name))]
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s structure with ``leaves`` in :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t: Any) -> Any:
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(t, **{f.name: build(getattr(t, f.name)) for f in dataclasses.fields(t)})
        if isinstance(t, Mapping):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
