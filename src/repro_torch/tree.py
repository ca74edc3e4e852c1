"""Nested-dict parameter and state trees: the port's counterpart of the
``jax.tree`` calls the reference makes over its pytrees. Tuples and lists
are interior nodes too (the ssm family's sLSTM state is a tuple of four
leaves, as in the reference)."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of the trees in ``rest``,
    which have its structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def flat_leaves(tree) -> List[Any]:
    """The leaves of a tree of dicts, tuples and lists, in order
    (``jax.tree.leaves``; dicts in insertion order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in flat_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in flat_leaves(v)]
    return [tree]


def tree_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(``/``-joined path, leaf) pairs of a tree of nested dicts, in
    insertion order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in tree_leaves(v, f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def tree_from_leaves(paths: List[str], leaves) -> Dict[str, Any]:
    """Inverse of ``tree_leaves`` for nested dicts."""
    tree: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree
