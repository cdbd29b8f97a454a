"""Environments of the port (pendulum so far)."""
from repro_torch.envs.core import Env, EnvSpec, make  # noqa: F401
