"""``repro_torch.elastic``: a population's size changed between runs
(``repro.elastic``, its single-card half).

  * :mod:`repro_torch.elastic.resize`: elastic shrink and grow (the worst
    members dropped, PBT clones refill), applied alike to training state,
    hypers, replay buffers and env states.
  * :mod:`repro_torch.elastic.relayout`: :func:`restore_elastic`, resume a
    ``PopTrainer`` and its attached engine from a checkpoint of another
    population size.

The JAX package's island layouts, its ``islands`` backend and
``relayout`` (placement over a device mesh) are not ported.
"""
from repro_torch.elastic.relayout import restore_elastic  # noqa: F401
from repro_torch.elastic.resize import (  # noqa: F401
    grow_population, plan_resize, resize_tree, shrink_population,
)
