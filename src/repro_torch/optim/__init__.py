"""Optimizers of the port (``repro.optim`` subset): stock Adam over a
parameter tree and the population-level Adam over member-stacked trees."""
from repro_torch.optim.optimizers import (  # noqa: F401
    AdamState, adam, apply_updates,
)
from repro_torch.optim.pop_adam import population_adam  # noqa: F401
