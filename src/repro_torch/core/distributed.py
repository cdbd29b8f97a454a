"""The population over several processes (``repro.core.distributed``).

The JAX package puts the population axis of every stacked tree on mesh
axes with ``NamedSharding`` and lets XLA insert the collectives. The port
runs one process per GPU (as ``torch.distributed.run`` launches them), so
"sharded" means: each rank holds the rows of its members, and the few
population-wide values cross ranks by explicit collectives.

  * :func:`population_axes` / :func:`population_sharding` — which leaves
    split over the mesh's population axes (``Shard(0)``) and which are
    replicated (``Replicate()``): a leaf splits when its leading dimension
    is the population size N and N divides over the axes; otherwise every
    rank holds (and computes) all members, as GSPMD does.
    :func:`shard_population` takes this rank's rows of the split leaves.
  * :func:`all_members_fitness` — the rows of every rank put together in
    member order, a ``(N, ...)`` tensor on every rank (fitness, metrics).
  * :class:`Rows` and :func:`member_generator` — a rank's member rows, and
    the generator that carries them. **Sharding decides where, never
    what**: a draw with a member axis (exploration noise, env resets,
    replay indices, update noise) goes through :func:`member_draw`, which
    makes it at the whole population's shape and keeps the rank's rows.
    Every rank therefore consumes the generator as a one-rank run does,
    and its members see the numbers they would see there.
  * :func:`owner_rows` and :func:`gather_columns_to_root` — the two
    collectives of CEM over ranks: some members' rows (the elites, or
    member 0) broadcast by their owners to every island, and a vector over
    one member's columns put back whole on rank 0 from the model ranks'
    parts (the checkpoint's CEM state).
  * :func:`copy_to_region`, :func:`reduce_from_region`,
    :func:`gather_from_region`, :func:`scatter_to_region` — the
    tensor-parallel collectives of a member sharded over an island's model
    axis, as autograd Functions; :func:`combine_softmax_parts`, attention
    over a KV cache whose sequence is split over that axis.

:func:`all_reduce`, :func:`broadcast` and :func:`all_gather` are the one
choke point of every collective above. Under :func:`recording` (the dry
run's counter, :mod:`repro_torch.launch.hlo_analysis`) they reach no
process group: each call is handed to the recorder, which counts it and
returns a result of the right shape, and a :class:`VirtualGroup` stands
for a group of a given size that no process joined.

Collectives on a gloo group go through the host when the tensor is on the
card (gloo's CUDA support covers few of them); NCCL takes device tensors.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import flatten, leaves, tree_map, unflatten

POPULATION_AXES = ("pod", "data")


class Rows(NamedTuple):
    """Members ``lo .. hi - 1`` of a population of ``n``."""
    lo: int
    hi: int
    n: int

    @property
    def count(self) -> int:
        return self.hi - self.lo


class MemberGenerator(torch.Generator):
    """A ``torch.Generator`` whose member-axis draws (:func:`member_draw`)
    are made at the whole population's shape, of which a rank keeps
    ``rows``. It draws, saves and restores its state as any generator."""

    rows: Rows


def member_generator(device, rows: Rows | None = None) -> torch.Generator:
    """The trainer's generator on ``device``: a plain one when the rank
    holds every member (``rows`` None or the whole population), else a
    :class:`MemberGenerator` carrying ``rows``."""
    if rows is None or rows.count == rows.n:
        return torch.Generator(device=device)
    gen = MemberGenerator(device=device)
    gen.rows = rows
    return gen


def member_rows(generator) -> Rows | None:
    """The rows a generator's draws keep, None for a plain generator."""
    return getattr(generator, "rows", None)


def member_draw(sampler, shape, generator, *, axis: int = 0):
    """``sampler(shape, generator=generator, device=generator.device)``
    where ``shape[axis]`` counts members (or a whole number of items per
    member, as the env axis ``N * E`` does). With a
    :class:`MemberGenerator` the draw is made with that axis at the whole
    population's length and the rank's part is returned, so it holds the
    numbers a one-rank run gives these members. ``sampler`` is
    ``torch.rand``, ``torch.randn`` or a ``functools.partial`` of
    ``torch.randint``."""
    shape = tuple(shape)
    rows = member_rows(generator)
    draw = dict(generator=generator, device=generator.device)
    if rows is None:
        return sampler(shape, **draw)
    per, rest = divmod(shape[axis], rows.count)
    if rest or not per:
        raise ValueError(
            f"a member-axis draw of {shape[axis]} along axis {axis} does not "
            f"split over this rank's {rows.count} members")
    full = shape[:axis] + (rows.n * per,) + shape[axis + 1:]
    return sampler(full, **draw).narrow(axis, rows.lo * per, shape[axis])


# ------------------------------------------------------------ placement
def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def population_axes(mesh) -> tuple:
    """The mesh axes the population splits over: ``pod`` and ``data``,
    where the mesh has them."""
    names = _names(mesh)
    return tuple(a for a in POPULATION_AXES if a in names)


def _axes_size(mesh, axes) -> int:
    names = _names(mesh)
    return int(np.prod([mesh.shape[names.index(a)] for a in axes])) \
        if axes else 1


def population_sharding(tree, mesh, n: int | None = None):
    """A placement for each leaf: ``Shard(0)`` over
    :func:`population_axes` for a leaf whose leading dimension is the
    population size ``n`` (the first leaf's, by default) when ``n``
    divides over those axes, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    size = _axes_size(mesh, population_axes(mesh))
    first = next(iter(leaves(tree)), None)
    pop = n if n is not None else (first.shape[0] if first is not None
                                   else 0)

    def spec(leaf):
        if (getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] == pop
                and size > 1 and pop % size == 0):
            return Shard(0)
        return Replicate()
    return tree_map(spec, tree)


def population_rows(mesh, n: int, rank: int | None = None) -> Rows:
    """This rank's rows of a population of ``n`` under
    :func:`population_sharding`: its block of the population axes, or
    every member when ``n`` does not divide over them."""
    axes = population_axes(mesh)
    size = _axes_size(mesh, axes)
    if size <= 1 or n % size:
        return Rows(0, n, n)
    coords = mesh.get_coordinate() if rank is None else \
        _coordinate(mesh, rank)
    names = _names(mesh)
    block = 0
    for a in axes:
        block = block * mesh.shape[names.index(a)] + coords[names.index(a)]
    per = n // size
    return Rows(block * per, (block + 1) * per, n)


def _coordinate(mesh, rank: int) -> list:
    where = (mesh.mesh == rank).nonzero()
    return where[0].tolist()


def take_rows(tree, rows: Rows):
    """The ``rows`` of every leaf whose leading dimension is ``rows.n``,
    each its own contiguous tensor; other leaves as they are."""
    if rows.count == rows.n:
        return tree

    def take(x):
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] == rows.n:
            x = torch.as_tensor(x) if isinstance(x, np.ndarray) else x
            return x[rows.lo:rows.hi].clone()
        return x
    return tree_map(take, tree)


def shard_population(tree, mesh):
    """This rank's part of ``tree`` under :func:`population_sharding`."""
    first = leaves(tree)[0]
    return take_rows(tree, population_rows(mesh, first.shape[0]))


# ---------------------------------------------------------- collectives
def world() -> tuple[int, int]:
    """``(rank, world size)``; ``(0, 1)`` without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class VirtualGroup(NamedTuple):
    """A process group of ``size`` ranks that no process joined: the dry
    run's model axis, whose collectives are recorded, never run."""
    name: str
    size: int


_RECORDER = None


@contextlib.contextmanager
def recording(recorder):
    """Context: every collective of this module is handed to
    ``recorder(kind, tensor, group)`` ("all-reduce", "broadcast" or
    "all-gather"), which returns its result, instead of reaching a process
    group."""
    global _RECORDER
    prev, _RECORDER = _RECORDER, recorder
    try:
        yield recorder
    finally:
        _RECORDER = prev


def group_size(group=None) -> int:
    """The number of ranks of ``group`` (a :class:`VirtualGroup`'s own)."""
    if isinstance(group, VirtualGroup):
        return group.size
    return dist.get_world_size(group)


def _via_host(tensor, group) -> bool:
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(tensor, group=None, op: str = "sum"):
    """Reduce ``tensor`` in place over ``group`` by ``op`` ("sum" or
    "max"; through the host on a gloo group)."""
    if _RECORDER is not None:
        return _RECORDER("all-reduce", tensor, group)
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if _via_host(tensor, group):
        host = tensor.cpu()
        dist.all_reduce(host, op=rop, group=group)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, op=rop, group=group)
    return tensor


def broadcast(tensor, src: int, group=None):
    """Broadcast ``tensor`` in place from global rank ``src`` (through the
    host on a gloo group)."""
    if _RECORDER is not None:
        return _RECORDER("broadcast", tensor, group)
    if _via_host(tensor, group):
        host = tensor.cpu()
        dist.broadcast(host, src, group=group)
        tensor.copy_(host)
    else:
        dist.broadcast(tensor, src, group=group)
    return tensor


def all_gather(tensor, group=None) -> list:
    """Every rank's ``tensor`` of ``group``, in group-rank order (through
    the host on a gloo group)."""
    if _RECORDER is not None:
        return _RECORDER("all-gather", tensor, group)
    size = dist.get_world_size(group)
    if _via_host(tensor, group):
        host = tensor.contiguous().cpu()
        out = [torch.empty_like(host) for _ in range(size)]
        dist.all_gather(out, host, group=group)
        return [x.to(tensor.device) for x in out]
    out = [torch.empty_like(tensor) for _ in range(size)]
    dist.all_gather(out, tensor.contiguous(), group=group)
    return out


# ------------------------------------------- tensor parallelism (TP)
# The collectives of a forward whose member is sharded over an island's
# model axis (``repro_torch.models.sharding.ModelShard``), as autograd
# Functions over this module's all_reduce and all_gather (on gloo they go
# through the host, which DTensor's redistribute would not). "Region" is
# the computation between a column-parallel and a row-parallel matmul, in
# which each rank holds its part. A value crosses the group in float32
# (a bf16 activation is widened for the collective and narrowed after),
# so a sum of partial products rounds once more than the one-rank matmul
# and no further.
def _wide(x):
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def _summed(x, shard):
    out = _wide(x).clone().contiguous()
    return all_reduce(out, shard.group).to(x.dtype)


def _gathered(x, dim: int, shard):
    parts = all_gather(_wide(x).contiguous(), shard.group)
    return torch.cat(parts, dim=dim).to(x.dtype)


def _part(x, dim: int, shard):
    lo, hi = shard.bounds(x.shape[dim])
    return x.narrow(dim, lo, hi - lo).contiguous()


class _CopyToRegion(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group
    (each rank's covers only its part of the region)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.shard), None


class _ReduceFromRegion(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward."""

    @staticmethod
    def forward(ctx, x, shard):
        return _summed(x, shard)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromRegion(torch.autograd.Function):
    """All-gather along ``dim`` forward; the backward keeps this rank's
    part of the gradient (the gathered value is used whole, the same on
    every rank)."""

    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        return _gathered(x, dim, shard)

    @staticmethod
    def backward(ctx, g):
        return _part(g, ctx.dim, ctx.shard), None, None


class _ScatterToRegion(torch.autograd.Function):
    """This rank's part along ``dim`` of a value every rank holds whole;
    the backward all-gathers the gradient, so the whole value's gradient
    is complete on every rank."""

    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        return _part(x, dim, shard)

    @staticmethod
    def backward(ctx, g):
        return _gathered(g, ctx.dim, ctx.shard), None, None


def copy_to_region(x, shard):
    """``x`` entering a column-parallel region: identity forward,
    all-reduce backward."""
    return _CopyToRegion.apply(x, shard)


def reduce_from_region(x, shard):
    """The partial sums of a row-parallel matmul, summed over the group
    (identity backward)."""
    return _ReduceFromRegion.apply(x, shard)


def gather_from_region(x, dim: int, shard):
    """Every rank's part of ``x`` along ``dim``, put together (the
    backward keeps this rank's part)."""
    return _GatherFromRegion.apply(x, dim, shard)


def scatter_to_region(x, dim: int, shard):
    """This rank's part of a whole ``x`` along ``dim`` (the backward
    all-gathers)."""
    return _ScatterToRegion.apply(x, dim, shard)


def combine_softmax_parts(m, l, o, shard):
    """Attention over a sequence split across ``shard``'s model group
    (the flash-decoding layout of a KV cache): this rank's row maxima
    ``m`` (...), sums of ``exp(logit - m)`` ``l`` (...) and
    exp-weighted values ``o`` (..., X) over its positions, float32,
    combined by log-sum-exp with one all-gather. Returns the softmax-
    weighted values over every position (..., X), float32, the same on
    every rank (each sums the parts in rank order)."""
    packed = torch.cat([m[..., None], l[..., None], o], dim=-1)
    parts = torch.stack(all_gather(packed.contiguous(), shard.group))
    top = parts[..., 0].amax(0)
    w = torch.exp(parts[..., 0] - top)
    return ((parts[..., 2:] * w[..., None]).sum(0)
            / (parts[..., 1] * w).sum(0)[..., None])


def all_members(tree, rows: Rows, group=None):
    """Every leaf's rows of all members, ``(rows.n, ...)`` on every rank:
    each rank writes its rows into zeros and ``group`` (one rank per
    member block, as the layout's ``pop`` group) sums them, which is exact.
    A leaf that already holds every member is returned as it is."""
    if rows.count == rows.n:
        return tree

    def gather(x):
        if x.shape[0] == rows.n:
            return x
        full = torch.zeros((rows.n,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device)
        full[rows.lo:rows.hi] = x
        return all_reduce(full, group)
    return tree_map(gather, tree)


def all_members_fitness(fitness, rows: Rows, group=None):
    """The ``(N,)`` fitness of every member on every rank, from each rank's
    ``(rows.count,)`` part (:func:`all_members`). The JAX package keeps
    fitness replicated so PBT's ranking is local on every device; so does
    this."""
    return all_members(fitness, rows, group)


def gather_to_root(tree, layout, group=None, dims=None):
    """On rank 0, every leaf's rows of all the layout's members, from the
    first rank of each island (host tensors); None on the other ranks.
    Every leaf of ``tree`` carries this rank's member rows. ``group`` is a
    group over the whole world whose ranks are the global ranks (gloo:
    the leaves go through the host). ``dims`` (one entry a leaf, in
    flatten order) names the dimension along which a leaf is this rank's
    part of a model-sharded member: it is put together whole from the
    island's model ranks (its first data rank's), so the result is the
    one-rank tree."""
    from repro_torch.device import to_host
    host = to_host(tree)
    rank, size = world()
    flat, treedef = flatten(host)
    dims = [None] * len(flat) if dims is None else list(dims)
    if len(dims) != len(flat):
        raise ValueError(f"{len(dims)} shard dims for {len(flat)} leaves")

    def island(parts, j, dim):
        if dim is None:
            return parts[layout.rank_of(j)]
        return torch.cat([parts[layout.rank_of(j, c)]
                          for c in range(layout.model)], dim=dim)

    def gather(x, dim):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)] \
            if rank == 0 else None
        dist.gather(x, parts, dst=0, group=group)
        return None if rank != 0 else torch.cat(
            [island(parts, j, dim) for j in range(layout.islands)])
    out = unflatten(treedef, [gather(x, d) for x, d in zip(flat, dims)])
    return out if rank == 0 else None


def owner_rows(block, members, layout, group=None):
    """Rows ``members`` of a population split over ``layout``'s islands,
    ``(len(members), C)`` on every rank in the order given: ``members``
    are population indices, the same list on every rank, and ``block`` is
    this rank's rows ``(rows.count, C)`` of the columns wanted (a model
    rank's columns of its parts). Each island that holds some of them
    broadcasts exactly those rows, from its rank in this rank's column,
    over ``group`` (that column's ``pop`` group), as
    :class:`MemberExchange` moves rows. Without a layout, or on one
    island, it is ``block[members]``."""
    index = lambda xs: torch.as_tensor(xs, device=block.device)
    if layout is None or layout.islands == 1:
        return block[index(members)]
    mine = layout.island_of()
    column = layout.position() % (layout.data * layout.model)
    per = layout.members_per_island
    shape = tuple(block.shape[1:])
    out = block.new_empty((len(members),) + shape)
    for j in range(layout.islands):
        at = [i for i, m in enumerate(members) if layout.owner(m) == j]
        if not at:
            continue
        buf = (block[index([members[i] - j * per for i in at])].contiguous()
               if mine == j else block.new_empty((len(at),) + shape))
        broadcast(buf, layout.rank_of(j, column), group)
        out[index(at)] = buf
    return out


def gather_columns_to_root(vector, layout, whole_of, group=None):
    """On rank 0, a vector over one member's columns (CEM's mean or
    variance) put back whole, in the one-rank ravel order, from the parts
    island 0's model ranks hold (``whole_of``:
    :meth:`repro_torch.models.sharding.PartMap.whole_of`), as a host
    tensor; None on the other ranks. Every rank calls it with its own
    ``(P_local,)`` part; only island 0's first data rank at each model
    coordinate sends its part, point to point to rank 0 over ``group``
    (a group over the whole world whose ranks are the global ranks:
    gloo, host tensors), so the traffic is one member's columns whatever
    the world's size."""
    rank, _ = world()
    sources = [layout.rank_of(0, c) for c in range(layout.model)]
    host = vector.detach().contiguous().cpu()
    if rank != 0:
        if rank in sources:
            dist.send(host, dst=0, group=group)
        return None
    parts = []
    for src in sources:
        if src == 0:
            parts.append(host)
            continue
        part = torch.empty_like(host)
        dist.recv(part, src=src, group=group)
        parts.append(part)
    return whole_of(parts)


class MemberExchange:
    """PBT's member copy (``PBT.gather``) over islands: member ``i``
    adopts member ``parents[i]``'s state where the parent may live on
    another rank.

    Every rank knows ``parents`` (the fitness is replicated, so PBT's
    ranking and draws are the same everywhere). For each island whose
    members are parents of members elsewhere, the rank of that island in
    this rank's data column broadcasts exactly those members' rows, leaf
    by leaf, over the group of the ranks that take them (groups are made
    once per rank set, by every rank in the same order). It moves only
    the rows PBT copies, never the population. Then the rank runs the
    agent's own gather (``gather_members``) for the parents it holds and
    writes the received rows into its members' slots, so an
    ``LMAgent``'s leaves stay views of its flat buffers. ``last`` holds
    the last exchange's ``seconds``, ``bytes`` (sent, counted once a
    broadcast) and ``members`` (rows sent)."""

    def __init__(self, gather, layout):
        self.gather = gather
        self.layout = layout
        self._groups: dict = {}
        self.last = {"seconds": 0.0, "bytes": 0, "members": 0}

    def _group(self, ranks: tuple):
        if len(ranks) == world()[1]:
            return None
        if ranks not in self._groups:
            self._groups[ranks] = dist.new_group(list(ranks))
        return self._groups[ranks]

    def __call__(self, pop_state, parents):
        import time
        lay = self.layout
        t0 = time.perf_counter()
        p = [int(x) for x in parents.tolist()]
        rows = lay.rows()
        mine = lay.island_of()
        column = lay.position() % (lay.data * lay.model)
        per = lay.members_per_island
        # for each source island: the members others copy, and who copies
        plan = []
        for j in range(lay.islands):
            takers = [i for i in range(rows.n)
                      if lay.owner(p[i]) == j and lay.owner(i) != j]
            if takers:
                plan.append((j, sorted({p[i] for i in takers}),
                             sorted({lay.owner(i) for i in takers})))
        received, sent, moved = {}, 0, 0
        state_leaves = leaves(pop_state)
        for j, members, islands in plan:
            groups = [self._group(tuple(sorted(
                lay.rank_of(i, c) for i in [j] + islands)))
                for c in range(lay.data * lay.model)]
            if mine != j and mine not in islands:
                continue
            src, group = lay.rank_of(j, column), groups[column]
            idx = torch.as_tensor([m - j * per for m in members],
                                  device=state_leaves[0].device)
            bufs = []
            for leaf in state_leaves:
                buf = leaf[idx].contiguous() if mine == j else torch.empty(
                    (len(members),) + tuple(leaf.shape[1:]),
                    dtype=leaf.dtype, device=leaf.device)
                broadcast(buf, src, group)
                sent += buf.numel() * buf.element_size()
                bufs.append(buf)
            moved += len(members)
            if mine != j:
                received.update({m: (k, bufs) for k, m in enumerate(members)})
        local = [p[i] - rows.lo if lay.owner(p[i]) == mine else i - rows.lo
                 for i in range(rows.lo, rows.hi)]
        new_state = self.gather(pop_state, torch.as_tensor(
            local, device=state_leaves[0].device))
        new_leaves = leaves(new_state)
        for i in range(rows.lo, rows.hi):
            if p[i] in received:
                k, bufs = received[p[i]]
                for leaf, buf in zip(new_leaves, bufs):
                    leaf[i - rows.lo].copy_(buf[k])
        self.last = {"seconds": time.perf_counter() - t0, "bytes": sent,
                     "members": moved}
        return new_state
