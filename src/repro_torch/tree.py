"""Minimal pytree helpers over nested dicts, lists, tuples and NamedTuples.

Leaves come out in the JAX package's flatten order: dict keys SORTED (so
``layer_10`` comes before ``layer_2``), sequences and NamedTuple fields in
order, ``None`` an empty subtree. The checkpoint layout numbers its
``leaf_<i>`` arrays in that order, so checkpoints written by either package
read back in the other. (``torch.utils._pytree`` keeps dict insertion
order, which would silently permute the leaves.)
"""
from __future__ import annotations

import torch

_LEAF = "*"


def flatten(tree):
    """-> (leaves, treedef)."""
    leaves = []

    def rec(node):
        if node is None:
            return (None, None, ())
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return (dict, keys, tuple(rec(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            return (type(node), None, tuple(rec(c) for c in node))
        leaves.append(node)
        return _LEAF

    return leaves, rec(tree)


def unflatten(treedef, leaves):
    it = iter(leaves)

    def rec(d):
        if d == _LEAF:
            return next(it)
        kind, keys, children = d
        vals = [rec(c) for c in children]
        if kind is None:
            return None
        if kind is dict:
            return dict(zip(keys, vals))
        if hasattr(kind, "_fields"):
            return kind(*vals)
        return kind(vals)

    out = rec(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("unflatten: more leaves than the structure holds")
    return out


def num_leaves(treedef) -> int:
    if treedef == _LEAF:
        return 1
    return sum(num_leaves(c) for c in treedef[2])


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of trees of the same structure."""
    flat, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError("tree_map: trees differ in structure")
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])


def stack(trees):
    """List of per-member trees -> one tree with a leading member axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)
