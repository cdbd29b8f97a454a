"""Device-topology planning: islands over the population axis
(``repro.elastic.layout``).

The paper's §5.1 scaling recipe is *islands of vectorized members per
accelerator* (80 agents = 4 accelerators x 20 vectorized members): the
population axis is split over a ``"pop"`` mesh axis (one group of members
per island), and whatever ranks remain form the ``"data"`` / ``"model"``
axes *inside* each island. :class:`IslandLayout` is that decomposition as
a value, pure math until ``.mesh`` builds the ``DeviceMesh`` over the
world's ranks, and :func:`plan_layout` chooses it from the rank count and
the population size:

    >>> plan_layout(num_devices=4, population=20)       # the paper's setup
    IslandLayout(devices=4, islands=4, data=1, model=1, population=20, device_ids=None)

The port runs one process per GPU, so a "device" is a rank. Rank ``r``
(its position in ``device_ids``, when given) sits at island
``r // (data * model)`` and holds that island's ``members_per_island``
consecutive members: placement is slicing (:meth:`IslandLayout.place`).
An island with ``data > 1`` holds its members on each of its data ranks,
which all run the island's update on the same rows (where the JAX
package's GSPMD branch puts them: split over ``"pop"`` only). Over a
``model`` axis above 1, ``place(model_rules=True)`` (the LM population)
also cuts each member leaf to this rank's part by the rules of
:mod:`repro_torch.models.sharding`; without the rules (the RL members)
every model rank holds its island's members whole, as the JAX package
places them. A rank's model coordinate is its position modulo ``model``.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

from repro_torch.core.distributed import Rows, take_rows, world
from repro_torch.tree import leaves, tree_map


def _fit_model_axis(num_devices: int, preferred_model: int) -> int:
    """Largest width <= preferred that divides the device count, halving on
    the way down (model-parallel groups must be whole)."""
    model = max(1, preferred_model)
    while model > 1 and (num_devices % model or num_devices // model < 1):
        model //= 2
    return model


def plan_grid(num_devices: int, *, preferred_model: int = 16,
              multi_pod: bool = False):
    """The (shape, axis_names) grid ``plan_mesh`` would build — pure math,
    so launchers (and tests) can plan for rank counts this run doesn't
    have.

    When ``preferred_model`` does not divide ``num_devices`` the width is
    halved until it does; if nothing fits, the grid degenerates to
    ``(num_devices, 1)`` — pure data parallelism, each member's model
    unsharded.  Both fallbacks warn, because a silently-shrunk model axis
    changes the memory-per-device budget the caller sized for.
    """
    model = _fit_model_axis(num_devices, preferred_model)
    if model != preferred_model:
        warnings.warn(
            f"plan_mesh: preferred_model={preferred_model} does not divide "
            f"num_devices={num_devices}; falling back to model={model}"
            + (" (pure data parallelism — model axis gone)"
               if model == 1 else ""),
            stacklevel=2)
    data = num_devices // model
    axes = ("data", "model")
    shape = (data, model)
    if multi_pod and data % 2 == 0:
        shape, axes = (2, data // 2, model), ("pod", "data", "model")
    return shape, axes


def plan_mesh(num_devices: int, *, preferred_model: int = 16,
              multi_pod: bool = False):
    """Largest usable (data, model) mesh for the world's ranks (see
    :func:`plan_grid` for the policy and the fallback warnings)."""
    from repro_torch.launch.mesh import build_mesh
    shape, axes = plan_grid(num_devices, preferred_model=preferred_model,
                            multi_pod=multi_pod)
    return build_mesh(shape, axes)


@dataclass(frozen=True)
class IslandLayout:
    """A partition of ``devices`` ranks into ``islands`` member groups,
    each island an internal (data, model) grid.

    Pure math (hashable, printable, comparable); ``.mesh`` builds the
    ``DeviceMesh`` with dimensions ``("pop", "data", "model")`` over the
    world's ranks, once, and returns the same object after.
    ``device_ids`` optionally pins the layout to an explicit rank sequence
    (in mesh order), where "ranks 0 .. devices-1 in order" is the wrong
    order for the machine's locality.
    """
    devices: int
    islands: int
    data: int
    model: int
    population: int
    device_ids: tuple = None

    def __post_init__(self):
        if self.islands * self.data * self.model != self.devices:
            raise ValueError(f"{self} does not tile its devices")
        if self.population % self.islands:
            raise ValueError(
                f"population={self.population} does not split into "
                f"{self.islands} whole islands")
        if self.device_ids is not None:
            ids = tuple(int(d) for d in self.device_ids)
            if len(ids) != self.devices:
                raise ValueError(
                    f"{len(ids)} explicit device ids for a layout of "
                    f"{self.devices} devices")
            if len(set(ids)) != len(ids):
                raise ValueError(f"duplicate device ids in {ids}")
            object.__setattr__(self, "device_ids", ids)

    @property
    def members_per_island(self) -> int:
        return self.population // self.islands

    def position(self, rank: int | None = None) -> int:
        """Where ``rank`` (default: this process's) sits in mesh order."""
        rank = world()[0] if rank is None else rank
        if self.device_ids is None:
            return rank
        return self.device_ids.index(rank)

    def island_of(self, rank: int | None = None) -> int:
        return self.position(rank) // (self.data * self.model)

    def rank_of(self, island: int, within: int = 0) -> int:
        """The global rank at ``within`` inside ``island`` (its first rank
        by default)."""
        pos = island * self.data * self.model + within
        return pos if self.device_ids is None else self.device_ids[pos]

    def rows(self, rank: int | None = None) -> Rows:
        """The member rows ``rank``'s island holds."""
        lo = self.island_of(rank) * self.members_per_island
        return Rows(lo, lo + self.members_per_island, self.population)

    def owner(self, member: int) -> int:
        """The island that holds ``member``."""
        return member // self.members_per_island

    @property
    def mesh(self):
        """The ``DeviceMesh`` over the world's ranks; None for a layout of
        one device without a process group (a world of one). Built once
        per process group."""
        import torch.distributed as dist
        group = dist.group.WORLD if dist.is_initialized() else None
        cached = _MESH_CACHE.get(self)
        if cached is None or cached[0] is not group:
            cached = _MESH_CACHE[self] = (group, _build_mesh(self))
        return cached[1]

    def model_coord(self, rank: int | None = None) -> int:
        """``rank``'s coordinate on its island's model axis."""
        return self.position(rank) % self.model

    def model_shard(self, rank: int | None = None):
        """``rank``'s :class:`~repro_torch.models.sharding.ModelShard`
        without a group (placement; the collectives take
        :func:`repro_torch.launch.mesh.model_shard`'s), or None when the
        model axis is 1."""
        from repro_torch.models.sharding import ModelShard
        if self.model == 1:
            return None
        return ModelShard(self.model_coord(rank), self.model)

    def place(self, tree, rank: int | None = None, *,
              model_rules: bool = False):
        """A population tree placed onto the layout: ``rank``'s island's
        rows of every leaf whose leading dimension is the population (each
        its own tensor), every other leaf as it is (replicated).

        ``model_rules=True`` with a model axis above 1 also cuts each such
        leaf to ``rank``'s part along the dimension its rule shards
        (``spec_for(path, leaf.shape[1:])`` under ``population_mode``: the
        "F" axes resolve to None), each part its own contiguous tensor:
        the LM population's placement, where every member is sharded over
        its island's model ranks so that members larger than one card
        fit."""
        rows = self.rows(rank)
        placed = take_rows(tree, rows)
        if not model_rules or self.model == 1:
            return placed
        from repro_torch.models.sharding import local_tree, member_dims
        shard = self.model_shard(rank)
        dims = [d if getattr(x, "ndim", 0) >= 1
                and x.shape[0] == self.population else None
                for d, x in zip(member_dims(tree, shard), leaves(tree))]
        cut = local_tree(placed, dims, shard)
        return tree_map(lambda old, new: new if new is old
                        else new.contiguous().clone(), placed, cut)


_MESH_CACHE: dict = {}


def drop_meshes() -> None:
    """Forget every layout's mesh (before the process group is
    destroyed: :func:`repro_torch.launch.mesh.leave_distributed`)."""
    _MESH_CACHE.clear()


def _build_mesh(layout: IslandLayout):
    from repro_torch.launch.mesh import ISLAND_AXES, build_mesh
    _, available = world()
    if layout.devices != available:
        if layout.devices == 1 and available == 1:
            return None
        raise ValueError(
            f"{layout} needs {layout.devices} ranks but the world has "
            f"{available}; plan the layout for the ranks that exist "
            f"(plan_layout({available}, {layout.population})), or launch "
            f"with --nproc-per-node {layout.devices}")
    import torch.distributed as dist
    if not dist.is_initialized():
        return None
    return build_mesh((layout.islands, layout.data, layout.model),
                      ISLAND_AXES, ranks=layout.device_ids)


def plan_layout(num_devices: int, population: int, *,
                preferred_model: int = 1, devices=None) -> IslandLayout:
    """Choose the island decomposition for ``num_devices`` ranks and a
    population of ``population`` members.

    Policy (the paper's §5.1 regime): give the population axis as many
    islands as divide BOTH the population and the post-model device count
    (members stay whole and islands stay balanced), then spend the
    remainder on the data axis inside each island.  ``preferred_model > 1``
    reserves a model-parallel grid per member first (large-member
    populations), falling back with a warning exactly like ``plan_mesh``.

    ``devices`` optionally pins the layout to an explicit rank sequence
    (integer ids, in mesh order); it overrides ``num_devices`` (pass 0).
    """
    device_ids = None
    if devices is not None:
        device_ids = tuple(d.id if hasattr(d, "id") else int(d)
                           for d in devices)
        if num_devices and num_devices != len(device_ids):
            raise ValueError(
                f"num_devices={num_devices} disagrees with the "
                f"{len(device_ids)} explicit devices")
        num_devices = len(device_ids)
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if population < 1:
        raise ValueError(f"population must be >= 1, got {population}")
    model = _fit_model_axis(num_devices, preferred_model)
    if model != preferred_model:
        warnings.warn(
            f"plan_layout: preferred_model={preferred_model} does not "
            f"divide num_devices={num_devices}; falling back to "
            f"model={model}", stacklevel=2)
    remaining = num_devices // model
    islands = math.gcd(population, remaining)
    data = remaining // islands
    return IslandLayout(devices=num_devices, islands=islands, data=data,
                        model=model, population=population,
                        device_ids=device_ids)


def sharded_layout(num_devices: int, population: int) -> IslandLayout:
    """The layout ``backend="sharded"`` amounts to over ``num_devices``
    ranks (:func:`repro_torch.core.distributed.population_sharding` on a
    ``("data", "model")`` mesh with model 1): every rank its own island
    when the population divides over them, else one island whose members
    every rank holds and computes."""
    split = population % num_devices == 0
    islands = num_devices if split else 1
    return IslandLayout(devices=num_devices, islands=islands,
                        data=num_devices // islands, model=1,
                        population=population)
