"""Nested trees of tensors: the port's stand-in for the reference's JAX
pytrees (parameters, gradients, optimizer and train state).

A node is a mapping, a list or tuple, a dataclass instance or None; any
other value is a leaf. Children are visited in JAX's order: a mapping's keys
sorted, a list's items and a dataclass's fields by position (fields in
declaration order, the order in which the reference registers ``TrainState``
and ``OptState``). None holds no leaf. ``flatten_with_path`` names each leaf
as the reference's checkpoint does: the dict keys and positions on its path
joined by "/".
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Callable, Iterator, List, Optional, Tuple

SEP = "/"


def _children(node) -> Optional[List[Tuple[Any, Any]]]:
    """(key, child) pairs of an inner node in visiting order; None for a
    leaf."""
    if node is None:
        return []
    if isinstance(node, Mapping):
        return [(k, node[k]) for k in sorted(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(i, getattr(node, f.name))
                for i, f in enumerate(dataclasses.fields(node))]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _rebuild(node, children: List[Any]):
    """A node of ``node``'s kind holding ``children`` (visiting order)."""
    if node is None:
        return None
    if isinstance(node, Mapping):
        return dict(zip(sorted(node), children))
    if isinstance(node, (list, tuple)):
        return type(node)(children)
    return type(node)(*children)          # a dataclass, fields by position


def flatten_with_path(tree) -> List[Tuple[str, Any]]:
    """(path, leaf) for every leaf, in visiting order."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, [], out)
    return out


def _walk(node, path: List[str], out: List[Tuple[str, Any]]) -> None:
    # module level, not a closure: a recursive closure is a reference cycle
    # that would keep every leaf it saw alive until the next gc pass
    kids = _children(node)
    if kids is None:
        out.append((SEP.join(path), node))
        return
    for k, child in kids:
        _walk(child, path + [str(k)], out)


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(tree, new_leaves) -> Any:
    """``tree``'s structure holding ``new_leaves`` (visiting order)."""
    it: Iterator = iter(new_leaves)
    out = _build(tree, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _build(node, it: Iterator):
    kids = _children(node)
    if kids is None:
        return next(it)
    return _rebuild(node, [_build(child, it) for _, child in kids])


def map_leaves(fn: Callable, tree, *rest) -> Any:
    """``fn`` of each leaf of ``tree`` and the leaves at the same paths of
    ``rest``, in ``tree``'s structure."""
    flat = leaves(tree)
    others = [leaves(r) for r in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(flat, *others)])
