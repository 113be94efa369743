"""Nested-container helpers for parameter and cache trees: dicts, tuples
and lists whose leaves are tensors, arrays or specs (the port's stand-in
for ``jax.tree``)."""
from __future__ import annotations

from typing import Any, Callable, List


def _is_node(x) -> bool:
    return isinstance(x, (dict, tuple, list))


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable = None):
    """Apply ``fn`` leaf-wise over ``tree`` and any trees of the same
    structure in ``rest``; containers keep their type and key order."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or r.keys() != tree.keys() for r in rest):
            raise ValueError(f"tree structures differ at keys {sorted(tree)}")
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if any(not _is_node(r) or isinstance(r, dict) or len(r) != len(tree)
           for r in rest):
        raise ValueError(f"tree structures differ at a sequence of {len(tree)}")
    out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
           for i, v in enumerate(tree)]
    return tuple(out) if isinstance(tree, tuple) else out


def tree_leaves(tree, is_leaf: Callable = None) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out
