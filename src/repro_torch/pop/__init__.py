"""``repro.pop`` of the port: the agent adapters, evolution strategies,
the update backends and ``PopTrainer``."""
from repro_torch.pop.agent import (  # noqa: F401
    LMAgent, LMState, ModuleAgent, PPOAgent, SharedCriticAgent,
)
from repro_torch.pop.backend import make_update  # noqa: F401
from repro_torch.pop.strategy import (  # noqa: F401
    CEM, PBT, DvD, EvolutionStrategy, NoEvolution, make_strategy,
)
from repro_torch.pop.trainer import PopTrainer  # noqa: F401
