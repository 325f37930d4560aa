"""``repro_torch.tree`` against ``jax.tree_util``: the same leaves in the
same order, paths equal to ``keystr``, and maps that keep the structure
(exact: no arithmetic)."""
from typing import Any, NamedTuple

import numpy as np

from repro_torch.tree import (tree_leaves, tree_leaves_with_path, tree_map,
                              tree_map_with_path)


class Pair(NamedTuple):
    k: Any
    v: Any = ()


def _tree():
    x = [np.full((2,), i, np.float32) for i in range(7)]
    return {"b": [x[0], (x[1], None)], "a": Pair(x[2]),
            "c": {"z": x[3], "y": Pair(x[4], x[5])}, "d": x[6], "e": None}


def test_leaves_and_paths_match_jax():
    import jax
    tree = _tree()
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = tree_leaves_with_path(tree)
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    assert all(a is b for (_, a), (_, b) in zip(got, want))
    assert [id(x) for x in tree_leaves(tree)] == \
        [id(x) for x in jax.tree_util.tree_leaves(tree)]


def test_maps_keep_the_structure():
    tree = _tree()
    doubled = tree_map(lambda x, y: x + y, tree, tree)
    assert isinstance(doubled["a"], Pair) and doubled["a"].v == ()
    assert doubled["e"] is None and doubled["b"][1][1] is None
    for a, b in zip(tree_leaves(doubled), tree_leaves(tree)):
        np.testing.assert_array_equal(a, 2 * b)
    paths = tree_map_with_path(lambda p, _: p, tree)
    assert tree_leaves(paths) == [p for p, _ in tree_leaves_with_path(tree)]
    # an iterator over the leaves maps back onto the tree in order
    it = iter(range(7))
    assert tree_leaves(tree_map(lambda _: next(it), tree)) == list(range(7))
