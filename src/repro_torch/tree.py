"""Trees of tensors walked in ``jax.tree_util``'s order.

A tree is nested dicts, lists, tuples and NamedTuples.  Dict keys are
visited sorted, sequences and NamedTuple fields in order; ``None`` and
``()`` hold no leaf (a float KV cache's scales are ``()``); every other
value is a leaf.  A leaf's path is the string ``jax.tree_util.keystr``
prints for it (``['layers']['attn'].k``, ``[0]``), which is how a
checkpoint names its leaves.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

__all__ = ["is_namedtuple", "tree_leaves", "tree_leaves_with_path",
           "tree_map", "tree_map_with_path"]


def is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _map(fn: Callable, path: str, tree, rest: Sequence):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, f"{path}[{k!r}]", tree[k], [r[k] for r in rest])
                for k in sorted(tree)}
    if is_namedtuple(tree):
        return type(tree)(*(_map(fn, f"{path}.{name}", v,
                                 [r[i] for r in rest])
                            for i, (name, v) in enumerate(
                                zip(tree._fields, tree))))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, f"{path}[{i}]", v, [r[i] for r in rest])
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def tree_map_with_path(fn: Callable[..., Any], tree, *rest):
    """``tree`` with each leaf ``x`` replaced by ``fn(path, x, *the same
    leaf of each tree in rest)``; the trees share one structure.  Leaves
    are visited in :func:`tree_leaves` order."""
    return _map(fn, "", tree, rest)


def tree_map(fn: Callable[..., Any], tree, *rest):
    """:func:`tree_map_with_path` without the path."""
    return _map(lambda _, *xs: fn(*xs), "", tree, rest)


def tree_leaves_with_path(tree) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree_util`` flattening order."""
    out: List[Tuple[str, Any]] = []
    _map(lambda p, x: out.append((p, x)), "", tree, ())
    return out


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util`` flattening order."""
    return [x for _, x in tree_leaves_with_path(tree)]
