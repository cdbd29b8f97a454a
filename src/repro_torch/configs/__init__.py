"""Configuration dataclasses of the port (``repro.configs`` subset) and
the registry of the LM configs ported so far."""
from repro_torch.configs.base import (  # noqa: F401
    LM_SHAPES, HyperSpace, LMConfig, MLASpec, MoESpec, PopulationConfig,
    ShapeSpec, TrainConfig, applicable_shapes,
)
from repro_torch.configs.registry import get_config, list_configs  # noqa: F401
