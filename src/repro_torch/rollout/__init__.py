"""The acting side of the port (``repro.rollout``): batched envs per
member, the collector, the evaluator, the iteration and its fused
epochs, and the overlapped engine."""
from repro_torch.rollout.vecenv import (  # noqa: F401
    VecEnv, VecEnvState, episode_stats, reset_stats,
)
from repro_torch.rollout.collector import (  # noqa: F401
    Collector, default_exploration, exploration_policy,
)
from repro_torch.rollout.evaluator import Evaluator  # noqa: F401
from repro_torch.rollout.engine import RolloutEngine  # noqa: F401
from repro_torch.rollout.overlap import OverlapEngine  # noqa: F401
