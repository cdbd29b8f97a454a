"""The ``"islands"`` update backend (``repro.elastic.islands``): each
island's member group updated by its own rank.

The JAX package ``shard_map``s the vectorized update over the ``"pop"``
mesh axis of an :class:`~repro_torch.elastic.layout.IslandLayout`. The
port runs one process per GPU, so an island's body is the rank's own
call: the agent's population-level update over the rows it holds. No
communication exists in the update step at all (members are independent;
the only collectives of island training are the PBT exchange and the
fitness gather at evolve time, :class:`repro_torch.pop.PopTrainer`).

Registered under ``"islands"`` in the backend registry, so it is the same
one-line config swap as the others::

    PopulationConfig(size=8, backend="islands")

Update numerics are those of ``backend="vectorized"`` on the same members,
because sharding only decides *where* each member's update runs, never
what it computes: on a mesh of more than one island the generator must
be the trainer's :func:`~repro_torch.core.distributed.member_generator`,
whose member-axis draws are made at the whole population's shape and
sliced, and the call refuses a plain one.

On a mesh whose ``model`` axis is above 1, an agent with
``model_sharded_params`` (the LM) updates this rank's parts of its
island's members (``agent.fused_update(shard=...)``, the shard over the
mesh's ``model`` group: :func:`repro_torch.launch.mesh.model_shard`);
any other agent's members are whole on every model rank, which all run
the same update on them, as the JAX package places them.
"""
from __future__ import annotations

from repro_torch.core.distributed import member_rows
from repro_torch.core.vectorize import chain_steps
from repro_torch.launch.mesh import mesh_size, model_shard
from repro_torch.pop.backend import register_backend
from repro_torch.tree import leaves


def _build_islands(agent, num_steps: int, mesh=None):
    if getattr(agent, "population_level", False):
        raise ValueError("islands backend requires per-member agents (a "
                         "shared critic is replicated, not split over "
                         "islands)")
    shard = model_shard(mesh)
    if shard is not None and getattr(agent, "model_sharded_params", False):
        fn = agent.fused_update(shard=shard)
    else:
        fn = agent.fused_update()
    inner = fn if num_steps == 1 else chain_steps(fn, num_steps)
    islands = mesh_size(mesh, "pop")

    def stepped(pop_state, batches, hypers=None, generator=None, *,
                noise=None):
        if islands > 1 and noise is None:
            rows = member_rows(generator)
            n = leaves(pop_state)[0].shape[0]
            if rows is None or rows.count != n:
                raise ValueError(
                    f"an island's update of {n} members over {islands} "
                    f"islands needs the generator of its rows "
                    f"(repro_torch.core.distributed.member_generator), so "
                    f"its draws are the one-rank run's; got {rows}")
        return inner(pop_state, batches, hypers, generator, noise=noise)

    return stepped


register_backend("islands", _build_islands)
