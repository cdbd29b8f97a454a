"""``repro_torch.serve`` — population-as-ensemble inference.

  * :mod:`~repro_torch.serve.forward`    — :class:`PolicyForward`, the one
    deterministic policy forward.
  * :mod:`~repro_torch.serve.ensemble`   — :class:`ServingSet` +
    :func:`select_members` (fitness + DvD diversity).
  * :mod:`~repro_torch.serve.continuous` — :class:`ContinuousEvaluator`:
    watch a checkpoint dir, load only the actor stack, promote/demote.
  * :mod:`~repro_torch.serve.server`     — :class:`BatchServer`: pad/batch
    requests, run the ensemble and its mean/vote/best reduction.
"""
from repro_torch.serve.forward import PolicyForward  # noqa: F401
from repro_torch.serve.ensemble import (  # noqa: F401
    ServingSet, make_serving_set, select_members,
)
from repro_torch.serve.continuous import (  # noqa: F401
    ContinuousEvaluator, load_actor_stack, probe_observations,
)
from repro_torch.serve.server import BatchServer  # noqa: F401
