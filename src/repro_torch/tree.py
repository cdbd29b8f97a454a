"""Minimal pytree helpers over nested dicts, lists, tuples and NamedTuples.

Leaves come out in the JAX package's flatten order: dict keys SORTED (so
``layer_10`` comes before ``layer_2``), sequences and NamedTuple fields in
order, ``None`` an empty subtree. The checkpoint layout numbers its
``leaf_<i>`` arrays in that order, so checkpoints written by either package
read back in the other. (``torch.utils._pytree`` keeps dict insertion
order, which would silently permute the leaves.)

A member-stacked tree may live in ONE flat ``(N, P)`` buffer: its leaves,
in flatten order, are views of consecutive column ranges of the buffer
(:func:`flat_views`, :func:`flat_empty`, :func:`flat_copy`).
:func:`flat_buffer` returns that buffer from the leaves (the base torch
records for a view), so an optimizer asked to can update the whole
population in place while every caller keeps the tree.
"""
from __future__ import annotations

import math

import torch

_LEAF = "*"


def _flatten_into(node, leaves):
    if node is None:
        return (None, None, ())
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return (dict, keys, tuple(_flatten_into(node[k], leaves)
                                  for k in keys))
    if isinstance(node, (list, tuple)):
        return (type(node), None, tuple(_flatten_into(c, leaves)
                                        for c in node))
    leaves.append(node)
    return _LEAF


def flatten(tree):
    """-> (leaves, treedef). The recursion is a module-level function: a
    nested function that calls itself is a reference cycle, which would
    keep every leaf alive after the call until Python's cycle collector
    runs (61 GB of a served model's weights, for one)."""
    leaves = []
    return leaves, _flatten_into(tree, leaves)


def _unflatten_from(d, it):
    if d == _LEAF:
        return next(it)
    kind, keys, children = d
    vals = [_unflatten_from(c, it) for c in children]
    if kind is None:
        return None
    if kind is dict:
        return dict(zip(keys, vals))
    if hasattr(kind, "_fields"):
        return kind(*vals)
    return kind(vals)


def unflatten(treedef, leaves):
    it = iter(leaves)
    out = _unflatten_from(treedef, it)
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


def distinct(tree):
    """The tree with every leaf its own contiguous storage: a leaf that
    shares memory with an earlier one (two fields built from one zeros
    tensor) or is an expanded view is cloned, so copying a value into one
    leaf never writes another."""
    seen = set()

    def own(x):
        key = x.untyped_storage().data_ptr()
        if key in seen or not x.is_contiguous():
            x = x.clone(memory_format=torch.contiguous_format)
        seen.add(x.untyped_storage().data_ptr())
        return x

    return tree_map(own, tree)


def copy_into(dst, src):
    """Write ``src``'s leaves (numpy arrays or tensors) into ``dst``'s
    tensors in place, leaf by leaf, and return ``dst``: a restore that
    must not rebind the tensors (views of a flat buffer, a captured
    graph's static inputs). Raises ``ValueError`` on a structure or shape
    mismatch (``copy_`` alone would broadcast)."""
    mine, treedef = flatten(dst)
    theirs, src_def = flatten(src)
    if len(mine) != len(theirs):
        raise ValueError(f"copy_into: {len(theirs)} leaves into "
                         f"{len(mine)}")
    for d, s in zip(mine, theirs):
        s = torch.as_tensor(s)
        if tuple(s.shape) != tuple(d.shape):
            raise ValueError(f"copy_into: a leaf of shape "
                             f"{tuple(s.shape)} into one of "
                             f"{tuple(d.shape)}")
        d.copy_(s)
    return dst


def stack(trees):
    """List of per-member trees -> one tree with a leading member axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def flat_views(buffer, like):
    """The tree of ``like``'s structure and leaf shapes (each ``(N, ...)``)
    whose leaves are views of consecutive column ranges of ``buffer``, an
    ``(N, P)`` tensor, in flatten order."""
    shapes, treedef = flatten(like)
    outs, off = [], 0
    for leaf in shapes:
        size = math.prod(leaf.shape[1:])
        outs.append(buffer[:, off:off + size].view(leaf.shape))
        off += size
    if off != buffer.shape[1]:
        raise ValueError(f"flat_views: the leaves hold {off} columns, the "
                         f"buffer {buffer.shape[1]}")
    return unflatten(treedef, outs)


def flat_empty(like, *, dtype=torch.float32):
    """A new, uninitialised ``(N, P)`` buffer for the member-stacked tree
    ``like`` (on its device), and the tree of its views."""
    flat = leaves(like)
    n = flat[0].shape[0]
    p = sum(math.prod(l.shape[1:]) for l in flat)
    buffer = torch.empty((n, p), dtype=dtype, device=flat[0].device)
    return buffer, flat_views(buffer, like)


def flat_copy(tree, *, dtype=torch.float32):
    """``tree`` copied into a new ``(N, P)`` buffer: (buffer, views)."""
    buffer, views = flat_empty(tree, dtype=dtype)
    tree_map(lambda d, s: d.copy_(s), views, tree)
    return buffer, views


def flat_buffer(tree):
    """The ``(N, P)`` buffer whose views ``tree``'s leaves are, as
    :func:`flat_views` lays them out; raises ``ValueError`` when they are
    not."""
    flat = leaves(tree)
    base = flat[0]._base
    if base is None or base.ndim != 2:
        raise ValueError("flat_buffer: the leaves are not views of an "
                         "(N, P) buffer")
    for leaf, want in zip(flat, leaves(flat_views(base, tree))):
        if (leaf.data_ptr() != want.data_ptr()
                or leaf.stride() != want.stride()):
            raise ValueError("flat_buffer: the leaves are not laid out as "
                             "flat_views lays them")
    return base
