"""``repro_torch.elastic``: device topology and elasticity for population
training (``repro.elastic``).

  * :mod:`repro_torch.elastic.layout`: :class:`IslandLayout` /
    :func:`plan_layout`, the world's ranks partitioned into islands of
    members (population x data x model axes) from the rank count and the
    population size; :func:`plan_mesh` the (data, model) grid planner.
  * :mod:`repro_torch.elastic.islands`: the ``"islands"`` update backend,
    registered in the backend registry (a one-line config swap).
  * :mod:`repro_torch.elastic.resize`: elastic shrink and grow (the worst
    members dropped, PBT clones refill), applied alike to training state,
    hypers, replay buffers and env states.
  * :mod:`repro_torch.elastic.relayout`: :func:`restore_elastic`, resume a
    ``PopTrainer`` and its attached engine from a checkpoint of another
    population size, written on another number of ranks.

Train 8 members over the ranks ``torch.distributed.run`` started, then
resume with 6 on however many there are::

    pcfg = PopulationConfig(size=8, strategy="pbt", backend="islands")
    trainer = PopTrainer(agent, pcfg, checkpoint_dir=DIR)
    trainer.attach_rollout(env)
    trainer.run_env_loop(50)
    trainer.save(blocking=True)
    # --- restart on another world size with 6 members ---
    pcfg = PopulationConfig(size=6, strategy="pbt", backend="islands")
    trainer = PopTrainer(agent, pcfg, checkpoint_dir=DIR)
    trainer.attach_rollout(env)
    step, lineage = restore_elastic(trainer)  # 2 least-fit members dropped
    trainer.run_env_loop(50)                  # buffers and env states kept

``relayout`` places one large member's host tree over a mesh by the
sharding rules (this rank's part of every leaf).
"""
from repro_torch.elastic.layout import (  # noqa: F401
    IslandLayout, plan_layout, plan_mesh,
)
from repro_torch.elastic.relayout import relayout, restore_elastic  # noqa: F401
from repro_torch.elastic.resize import (  # noqa: F401
    grow_population, plan_resize, resize_tree, shrink_population,
)
from repro_torch.elastic import islands as _islands  # noqa: F401  (registers
#                                                "islands" update backend)
