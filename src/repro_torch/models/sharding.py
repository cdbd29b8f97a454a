"""Sharding rules: where each parameter and activation of a member lives
over an island's ``model`` axis (``repro.models.sharding``).

Conventions (mesh axes: optional "pod", then "data", "model"), as in the
JAX package:

  * TP — the "wide" dimension of every projection is sharded over
    ``model`` (attention heads, ffn columns, vocab);
  * FSDP — the other matmul dimension is sharded over ("pod", "data");
    under :class:`population_mode` (the population IS the data axis) every
    "F" request resolves to None, so a member is sharded by TP only;
  * stacked layer axes are never sharded;
  * an axis that does not divide its dimension is dropped (the dimension
    stays whole), so small configs fall back to replication.

A spec is the port's own: a tuple with one entry per dimension, each an
axis name, a tuple of axis names or None (``()`` for a leaf without a
rule), equal to ``tuple(jax.sharding.PartitionSpec(...))`` of the JAX
package's. :func:`spec_for` reads a mesh through its ``mesh_dim_names``
and ``shape`` (a ``DeviceMesh``, or a :class:`MeshShape` stand-in, which
plans without a process group).

The JAX package writes the rules as GSPMD requests and lets XLA insert the
collectives. The port runs one process per rank, so a sharded tensor IS
its local part: :class:`ModelShard` names this rank's place on the model
axis and its group, :func:`model_parallel` makes it the context of a
forward, and inside it

  * :func:`constrain` takes a value every rank of the group holds whole
    (replicated) to this rank's part of the spec asked for (a slice whose
    backward all-gathers the gradient, so the whole value's gradient is
    complete on every rank);
  * :func:`constrain_tree` does so for every leaf of a whole parameter
    tree by its rule (:func:`local_tree` is the same without autograd, for
    placement).

Outside a context (or on a model axis of 1) both return their input, as
the JAX package's do outside a mesh.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any

# parameter-name -> (spec for the trailing dims). Leading stacked layer
# axes are padded with None. "F" = fsdp axes, "M" = model.
_UP = ("F", "M")      # (d_in, d_out_wide)
_DOWN = ("M", "F")    # (d_in_wide, d_out)
_RULES = {
    # attention
    "wq": _UP, "wk": _UP, "wv": _UP, "wo": _DOWN,
    # mla
    "w_dkv": _UP, "w_kr": ("F", None), "w_ukv": (None, "M"),
    # glu mlp
    "w_gate": _UP, "w_up": _UP, "w_down": _DOWN,
    # moe (experts have a leading E dim sharded over model = EP)
    "router": ("F", None),
    "experts.w_gate": ("M", "F", None), "experts.w_up": ("M", "F", None),
    "experts.w_down": ("M", None, "F"),
    # rwkv6
    "wr": _UP, "wg": _UP,
    "mix_w1": ("F", None), "mix_w2": (None, None, None),
    "decay_w1": ("F", None), "decay_w2": (None, None),
    # mamba2
    "in_proj": _UP, "out_proj": _DOWN, "conv": (None, "M"),
    # embedding / head
    "embedding": ("M", "F"), "lm_head": ("F", "M"),
}


@dataclass(frozen=True)
class MeshShape:
    """A mesh's dimension names and sizes without its ranks: what
    :func:`spec_for` reads of a ``DeviceMesh``."""
    mesh_dim_names: tuple
    shape: tuple


def _axes(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def _size_of(mesh, name: str) -> int:
    return int(tuple(mesh.shape)[_axes(mesh).index(name)])


def fsdp_axes(mesh):
    names = _axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names) or None


_POPULATION_MODE = False


class population_mode:
    """Context: the ('pod', 'data') axes hold population members, so every
    'F' request inside the model resolves to None — member-internal
    sharding is TP only (the population IS the data axis)."""

    def __enter__(self):
        global _POPULATION_MODE
        self._prev = _POPULATION_MODE
        _POPULATION_MODE = True

    def __exit__(self, *exc):
        global _POPULATION_MODE
        _POPULATION_MODE = self._prev


def _resolve(sym, mesh):
    if sym == "F":
        return None if _POPULATION_MODE else fsdp_axes(mesh)
    if sym == "M":
        return "model" if "model" in _axes(mesh) else None
    return sym


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        size = 1
        for a in axis:
            size *= _size_of(mesh, a)
        return size
    return _size_of(mesh, axis)


def _entry(axis):
    """A spec entry as ``PartitionSpec`` keeps it: a one-axis tuple is
    that axis's name."""
    return axis[0] if isinstance(axis, tuple) and len(axis) == 1 else axis


def spec_for(path: str, shape, mesh) -> tuple:
    """The spec of the parameter at ``path`` (like
    ``'segments.dense.attn.wq.w'``) of ``shape`` on ``mesh``."""
    parts = [p for p in path.split(".") if p not in ("w",)]
    rule = None
    for span in (2, 1):           # longer (more specific) matches win
        for i in range(len(parts) - span + 1):
            key = ".".join(parts[i:i + span])
            if key in _RULES:
                rule = _RULES[key]
        if rule is not None:
            break
    if rule is None:
        return ()
    dims = [_resolve(s, mesh) for s in rule]
    # left-pad with None for stacked layer axes
    dims = [None] * (len(shape) - len(dims)) + dims
    # drop any axis that does not divide its dim
    return tuple(_entry(ax) if ax is not None
                 and d % _axis_size(mesh, ax) == 0 else None
                 for d, ax in zip(shape, dims))


def tree_paths(tree, prefix: str = "") -> list:
    """The dotted path of every leaf of ``tree``, in the flatten order of
    :mod:`repro_torch.tree` (dict keys sorted; a NamedTuple's fields by
    name, a sequence's items by index)."""
    if tree is None:
        return []
    join = lambda k: f"{prefix}.{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k],
                                                            join(k))]
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        return [p for k, c in zip(names, tree) for p in tree_paths(c,
                                                                   join(k))]
    return [prefix]


def param_specs(params, mesh):
    """A spec tree mirroring ``params`` (rules above). Its leaves are the
    spec tuples, which :mod:`repro_torch.tree` would walk into: pair them
    with ``params``' leaves through :func:`tree_paths`."""
    from repro_torch.tree import flatten, unflatten
    flat, treedef = flatten(params)
    return unflatten(treedef, [
        spec_for(p, tuple(x.shape), mesh)
        for p, x in zip(tree_paths(params), flat)])


def batch_spec(shape, mesh, *, leading_batch: bool = True) -> tuple:
    """The spec of a host batch array: batch over ('pod', 'data')."""
    f = fsdp_axes(mesh)
    if f is None or shape[0] % _axis_size(mesh, f) != 0:
        f = None
    return (_entry(f),) + (None,) * (len(shape) - 1)


# ------------------------------------------------------- the model axis
@dataclass(frozen=True)
class ModelShard:
    """This rank's place on an island's ``model`` axis of ``size`` ranks:
    its coordinate and the process group of the axis (None: slicing only,
    no collective)."""
    coord: int
    size: int
    group: Any = None

    @property
    def mesh(self) -> MeshShape:
        return MeshShape(("model",), (self.size,))

    def bounds(self, n: int) -> tuple:
        """This rank's ``(lo, hi)`` of a dimension of ``n`` split evenly."""
        if n % self.size:
            raise ValueError(f"a dimension of {n} does not split over a "
                             f"model axis of {self.size}")
        per = n // self.size
        return self.coord * per, (self.coord + 1) * per

    def is_part(self, local: int, whole: int) -> bool:
        """Whether a dimension of ``local`` is this rank's part of one of
        ``whole`` (False: it is whole)."""
        if local == whole:
            return False
        if local * self.size != whole:
            raise ValueError(f"a dimension of {local} is neither whole "
                             f"({whole}) nor a 1/{self.size} part of it")
        return True


_ACTIVE: ModelShard | None = None


@contextmanager
def model_parallel(shard: ModelShard | None):
    """The context of a model-sharded forward: inside it the model's
    blocks read :func:`active` and compute on this rank's parts. ``None``
    or a shard of size 1 is the one-rank forward."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = shard if shard is not None and shard.size > 1 else None
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def active() -> ModelShard | None:
    """The model shard of the forward being run, or None."""
    return _ACTIVE


def model_dim(spec) -> int | None:
    """The dimension a spec shards over ``model``, or None."""
    for d, ax in enumerate(spec):
        if ax == "model" or (isinstance(ax, tuple) and "model" in ax):
            return d
    return None


def _narrow(x, dim: int, shard: ModelShard):
    lo, hi = shard.bounds(x.shape[dim])
    return x.narrow(dim, lo, hi - lo)


def constrain(x, *spec):
    """``x``, a value every rank of the active model group holds whole,
    as this rank's part of ``spec`` (entries "M"/"model" shard a
    dimension over the group; "F" and None keep it whole, since a member
    is sharded by TP only). A dimension that does not divide stays whole.
    The backward all-gathers the gradient. Outside a model-parallel
    context ``x`` is returned as it is."""
    shard = active()
    if shard is None:
        return x
    from repro_torch.core.distributed import scatter_to_region
    for d, sym in enumerate(spec):
        if sym in ("M", "model") and x.shape[d] % shard.size == 0:
            x = scatter_to_region(x, d, shard)
    return x


def constrain_tree(params):
    """Every leaf of a whole parameter (sub)tree as this rank's part of
    its rule (:func:`constrain` of :func:`spec_for` under
    :class:`population_mode`); the tree as it is outside a context."""
    shard = active()
    if shard is None:
        return params
    from repro_torch.tree import flatten, unflatten
    flat, treedef = flatten(params)
    with population_mode():
        specs = [spec_for(p, tuple(x.shape), shard.mesh)
                 for p, x in zip(tree_paths(params), flat)]
    return unflatten(treedef, [
        x if model_dim(s) is None else constrain(
            x, *["M" if i == model_dim(s) else None
                 for i in range(x.ndim)])
        for x, s in zip(flat, specs)])


def member_dims(tree, shard: ModelShard, *, lead: int = 1) -> list:
    """For each leaf of a whole population tree (leaves ``(N, ...)`` when
    ``lead`` is 1), the dimension of the leaf that its rule shards over a
    model axis of ``shard.size`` (under :class:`population_mode`, on the
    dimensions after the first ``lead``), or None."""
    from repro_torch.tree import leaves
    out = []
    with population_mode():
        for path, x in zip(tree_paths(tree), leaves(tree)):
            if getattr(x, "ndim", 0) < lead:
                out.append(None)
                continue
            d = model_dim(spec_for(path, tuple(x.shape[lead:]), shard.mesh))
            out.append(None if d is None else d + lead)
    return out


def local_tree(tree, dims, shard: ModelShard):
    """``tree`` with each leaf narrowed to this rank's part along its
    entry of ``dims`` (None: whole); views, no autograd."""
    import torch
    from repro_torch.tree import flatten, unflatten
    flat, treedef = flatten(tree)
    if len(dims) != len(flat):
        raise ValueError(f"{len(dims)} shard dims for {len(flat)} leaves")
    out = []
    for x, d in zip(flat, dims):
        if d is not None:
            x = _narrow(torch.as_tensor(x), d, shard)
        out.append(x)
    return unflatten(treedef, out)


class PartMap:
    """Where this rank's parts of one member's parameters sit in the
    member's raveled vector (:func:`repro_torch.core.cem.ravel`'s order:
    the leaves in flatten order, each raveled row-major), and where its
    own flat buffer holds them (the parts in the same leaf order, each
    raveled row-major): the map CEM refits and redraws a model-sharded
    member by.

    ``shapes`` are one whole member's leaf shapes in flatten order and
    ``dims`` the dimension the rules cut in each (None: whole), over
    ``shard``'s model axis. A leaf is viewed as ``(A, S, B)`` around its
    cut dimension ``S``; this rank holds ``[lo, hi)`` of ``S`` in every
    one of the ``A`` outer rows. Nothing of the size of the member is
    materialised: :meth:`pieces` maps a block of whole columns to at most
    three slices a leaf."""

    def __init__(self, shapes, dims, shard: ModelShard):
        import math
        if len(shapes) != len(dims):
            raise ValueError(f"{len(dims)} shard dims for {len(shapes)} "
                             f"leaves")
        self.shard = shard
        self.leaves = []        # (whole offset, local offset, A, S, B, cut)
        whole = local = 0
        for shape, d in zip(shapes, dims):
            shape = tuple(shape)
            if d is None:
                a, s, b = 1, 1, math.prod(shape)
            else:
                a, s, b = (math.prod(shape[:d]), shape[d],
                           math.prod(shape[d + 1:]))
                shard.bounds(s)          # raises when it does not split
            self.leaves.append((whole, local, a, s, b, d is not None))
            whole += a * s * b
            local += a * (s // shard.size if d is not None else s) * b
        self.whole, self.local = whole, local

    def _cut(self, s: int, cut: bool, coord: int | None = None):
        if not cut:
            return 0, s
        per = s // self.shard.size
        c = self.shard.coord if coord is None else coord
        return c * per, (c + 1) * per

    def pieces(self, c0: int, c1: int):
        """The parts of whole columns ``[c0, c1)`` this rank holds, as
        ``(local, select)`` pairs: ``local`` its ``(lo, hi)`` columns of
        the rank's buffer, ``select(block)`` those columns of ``block``,
        an ``(n, c1 - c0)`` tensor of the whole columns (a view where the
        part is contiguous there)."""
        out = []
        for w0, l0, a, s, b, cut in self.leaves:
            lo_d, hi_d = self._cut(s, cut)
            row, q = s * b, (hi_d - lo_d) * b
            x0, x1 = max(c0, w0) - w0, min(c1, w0 + a * row) - w0
            if x0 >= x1:
                continue
            shift = w0 - c0
            full0, full1 = -(-x0 // row), x1 // row
            if full1 > full0:
                def select(block, f0=full0, f1=full1, row=row, shift=shift,
                           lo=lo_d * b, hi=hi_d * b):
                    rows = block[:, f0 * row + shift:f1 * row + shift]
                    part = rows.reshape(block.shape[0], f1 - f0, row)
                    return part[:, :, lo:hi].reshape(block.shape[0], -1)
                out.append(((l0 + full0 * q, l0 + full1 * q), select))
                partial = [r for r in {x0 // row, (x1 - 1) // row}
                           if r < full0 or r >= full1]
            else:
                partial = range(x0 // row, (x1 - 1) // row + 1)
            for r in sorted(partial):
                s0 = max(x0, r * row + lo_d * b)
                s1 = min(x1, r * row + hi_d * b)
                if s0 >= s1:
                    continue
                at = l0 + r * q + s0 - r * row - lo_d * b
                out.append(((at, at + s1 - s0),
                            lambda block, s0=s0 + shift, s1=s1 + shift:
                            block[:, s0:s1]))
        return out

    def local_of(self, vector):
        """This rank's columns of a whole ``(P,)`` vector, ``(P_local,)``."""
        out = vector.new_empty((self.local,))
        for (lo, hi), select in self.pieces(0, self.whole):
            out[lo:hi] = select(vector[None])[0]
        return out

    def whole_of(self, parts):
        """The whole ``(P,)`` vector from every model rank's columns
        (``parts[c]`` the ``(P_local,)`` vector of coordinate ``c``)."""
        import torch
        out = []
        for w0, l0, a, s, b, cut in self.leaves:
            if not cut:
                out.append(parts[0][l0:l0 + a * s * b])
                continue
            q = s // self.shard.size
            out.append(torch.cat([p[l0:l0 + a * q * b].view(a, q, b)
                                  for p in parts], dim=1).reshape(-1))
        return torch.cat(out)
