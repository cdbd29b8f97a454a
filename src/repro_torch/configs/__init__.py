"""Configuration dataclasses of the port (``repro.configs`` subset) and
the registry of the LM configs ported so far."""
from repro_torch.configs.base import (HyperSpace, LMConfig,  # noqa: F401
                                      MLASpec, MoESpec, PopulationConfig,
                                      TrainConfig)
from repro_torch.configs.registry import get_config, list_configs  # noqa: F401
