"""``repro.pop`` of the port: the agent adapter, evolution strategies, the
update backend and ``PopTrainer``."""
from repro_torch.pop.agent import ModuleAgent  # noqa: F401
from repro_torch.pop.backend import make_update  # noqa: F401
from repro_torch.pop.strategy import (  # noqa: F401
    PBT, EvolutionStrategy, NoEvolution, make_strategy,
)
from repro_torch.pop.trainer import PopTrainer  # noqa: F401
