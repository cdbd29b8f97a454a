"""``ModuleAgent`` — the agent adapter over a functional RL module
(``repro.pop.agent``), with the surface serving uses: ``init``,
``population_init``, ``policy`` and ``actor_params``. Updates come with
the training slice."""
from __future__ import annotations

from repro_torch.core.population import population_init
from repro_torch.device import DEFAULT_DEVICE, resolve_device


class ModuleAgent:
    """Adapter for a module exposing ``init(generator, obs_dim, act_dim,
    device=...) -> state`` (a state with an ``actor`` field) and
    ``policy(actor_params, obs, generator)``.

    ``device`` is where the agent's parameters live: the CUDA device unless
    the caller passes ``"cpu"``."""

    def __init__(self, module, obs_dim: int, act_dim: int, *,
                 device=DEFAULT_DEVICE):
        self.module = module
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.device = resolve_device(device)

    def init(self, generator):
        return self.module.init(generator, self.obs_dim, self.act_dim,
                                device=self.device)

    def population_init(self, generator, n: int):
        return population_init(self.init, generator, n)

    def policy(self, actor_params, obs, generator=None):
        return self.module.policy(actor_params, obs, generator)

    def actor_params(self, pop_state):
        return pop_state.actor
