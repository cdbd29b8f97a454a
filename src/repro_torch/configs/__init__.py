"""Configuration dataclasses of the port (``repro.configs`` subset)."""
from repro_torch.configs.base import HyperSpace, PopulationConfig  # noqa: F401
