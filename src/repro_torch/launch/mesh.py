"""Process groups and device meshes over the world's ranks
(``repro.launch.mesh``).

The JAX package builds a ``jax.sharding.Mesh`` over the devices one
controller sees. The port runs one process per GPU, launched by
``torch.distributed.run`` (which sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``), and its mesh is a ``DeviceMesh`` over those ranks.

:func:`init_distributed` is the process-group setup: the device is
``cuda:LOCAL_RANK`` and the backend NCCL when the run is on the card, gloo
on the CPU. It never falls back: NCCL failing to start raises. Without
``WORLD_SIZE`` in the environment (a plain ``python`` run) there is no
group, and the run is a world of one. The meshes are functions, so
importing this module touches no process group. :func:`leave_distributed`
is the way out: a gloo subgroup still referenced when the interpreter
exits aborts the process ("terminate called without an active
exception"), so the meshes go before the group does.
"""
from __future__ import annotations

import gc
import math
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.core.distributed import world

# the mesh's dimension names, as the JAX package's island meshes
ISLAND_AXES = ("pop", "data", "model")


def init_distributed(device="cuda", *, timeout: float = 600.0
                     ) -> torch.device:
    """Join the process group that ``torch.distributed.run`` describes in
    the environment and return this rank's device: ``cuda:LOCAL_RANK`` with
    NCCL when ``device`` is a CUDA device, the CPU with gloo otherwise.
    Without ``WORLD_SIZE`` in the environment there is no group and
    ``device`` is returned as it is; a group already joined is kept."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if "WORLD_SIZE" not in os.environ:
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            timeout=timedelta(seconds=timeout),
            device_id=dev if dev.type == "cuda" else None)
    return dev


def leave_distributed() -> None:
    """Destroy the process group, after dropping every reference this
    process holds to its meshes and subgroups (the layouts' mesh cache, and
    whatever a cycle keeps alive). A ``DeviceMesh`` subgroup that outlives
    ``destroy_process_group`` is torn down at the interpreter's exit,
    where gloo aborts the rank, and its peer is then killed. A no-op
    without a group."""
    if not dist.is_initialized():
        return
    from repro_torch.elastic.layout import drop_meshes
    drop_meshes()
    gc.collect()
    dist.destroy_process_group()


def mesh_size(mesh, name: str) -> int:
    """The size of ``mesh``'s dimension ``name``; 1 without a mesh or
    without that dimension."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def model_shard(mesh):
    """This rank's :class:`~repro_torch.models.sharding.ModelShard` on
    ``mesh``'s ``model`` dimension: its coordinate there and the
    dimension's process group (``mesh.get_group("model")``), over which
    the tensor-parallel collectives of a model-sharded member run; None
    without a mesh or on a model dimension of 1."""
    from repro_torch.models.sharding import ModelShard
    size = mesh_size(mesh, "model")
    if size == 1:
        return None
    group = mesh.get_group("model")
    return ModelShard(dist.get_rank(group), size, group)


def mesh_device_type() -> str:
    """``"cuda"`` on an NCCL group, ``"cpu"`` on gloo (gloo ranks may share
    one card; their mesh sets no device)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def build_mesh(shape, names, ranks=None):
    """A ``DeviceMesh`` of ``shape`` and dimension ``names`` over the
    world's ranks in order, or over ``ranks`` (every rank of the world, in
    the order given). Every rank calls it."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    size = math.prod(shape)
    if not dist.is_initialized():
        raise ValueError(
            f"a mesh of shape {tuple(shape)} needs a process group: launch "
            f"with python -m torch.distributed.run --nproc-per-node {size} "
            f"...")
    _, n = world()
    if size != n:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {size} "
                         f"ranks but the world has {n}")
    if ranks is None:
        return init_device_mesh(mesh_device_type(), tuple(shape),
                                mesh_dim_names=tuple(names))
    return DeviceMesh(mesh_device_type(),
                      torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The JAX package's production grid: (16, 16) ``("data", "model")``,
    or (2, 16, 16) with a ``"pod"`` axis. It needs a world of 256 (512)
    ranks and raises on any other."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    _, n = world()
    if n != need:
        raise ValueError(
            f"make_production_mesh(multi_pod={multi_pod}) needs a world of "
            f"{need} ranks; this one has {n} (make_host_mesh fits any world)")
    return build_mesh(shape, axes)


def make_host_mesh(model: int = 2, data: int | None = None, *,
                   pod: int | None = None):
    """A small mesh over the world's ranks: ``("data", "model")``, or
    ``("pod", "data", "model")`` with ``pod``; ``data`` defaults to what
    the other axes leave."""
    _, n = world()
    if pod:
        data = data or n // (model * pod)
        return build_mesh((pod, data, model), ("pod", "data", "model"))
    data = data or max(1, n // model)
    return build_mesh((data, model), ("data", "model"))
