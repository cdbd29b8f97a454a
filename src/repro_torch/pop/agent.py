"""``ModuleAgent`` — the agent adapter over a functional RL module
(``repro.pop.agent``): what ``PopTrainer``, the rollout engine and the
serving layer consume."""
from __future__ import annotations

from repro_torch.core.population import population_init
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.tree import tree_map


class ModuleAgent:
    """Adapter for a module exposing ``init(generator, obs_dim, act_dim,
    device=...) -> state`` (a state with an ``actor`` field),
    ``actor_init`` (one member's actor alone), ``policy``/``pop_policy``
    and ``make_population_update``.

    ``device`` is where the agent's parameters live: the CUDA device unless
    the caller passes ``"cpu"``. The population-level update always goes
    through the ``pop_matmul`` and ``pop_adam`` wrappers: the kernels on
    CUDA tensors, their plain versions on CPU tensors.
    """

    population_level = False     # the update is NOT the shared-critic kind
    experience_kind = "replay"   # transitions from a FIFO ring

    def __init__(self, module, obs_dim: int, act_dim: int, *,
                 device=DEFAULT_DEVICE):
        self.module = module
        self.exploration_module = module
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.device = resolve_device(device)

    @property
    def default_hypers(self) -> dict:
        return dict(getattr(self.module, "DEFAULT_HYPERS", {}))

    def init(self, generator):
        return self.module.init(generator, self.obs_dim, self.act_dim,
                                device=self.device)

    def population_init(self, generator, n: int):
        return population_init(self.init, generator, n)

    def actor_init(self, generator, *, device="cpu"):
        """One member's actor parameters, without the rest of the state."""
        return self.module.actor_init(generator, self.obs_dim, self.act_dim,
                                      device=device)

    def fused_update(self):
        """The module's population-level update, every linear through the
        ``pop_matmul`` wrapper and every Adam step through ``pop_adam``."""
        return self.module.make_population_update(fused_linear=True)

    def policy(self, actor_params, obs, generator=None):
        return self.module.policy(actor_params, obs, generator)

    def actor_params(self, pop_state):
        return pop_state.actor

    def gather_members(self, pop_state, parents):
        """PBT exploit: member i adopts member ``parents[i]``'s state."""
        return tree_map(lambda x: x[parents], pop_state)
