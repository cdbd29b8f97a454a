"""Environments of the port: the classic-control five and hopper2d."""
from repro_torch.envs.core import Env, EnvSpec, make  # noqa: F401
