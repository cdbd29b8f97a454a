"""Data of the port (``repro.data`` subset): the experience contract (the
replay ring and the trajectory buffer of the whole population, GAE), the
synthetic LM token pipeline, the prefetcher and the double buffer."""
from repro_torch.data.experience import (  # noqa: F401
    EXPERIENCE_KINDS, ExperienceOps, TrajectoryBuffer, compute_gae,
    experience_ops, select_items, traj_add, traj_full, traj_init, traj_reset,
    trajectory_spec, transition_spec,
)
from repro_torch.data.lm_pipeline import (  # noqa: F401
    host_batches, synthetic_token_stream,
)
from repro_torch.data.prefetch import DoubleBuffer, Prefetcher  # noqa: F401
from repro_torch.data.replay_buffer import (  # noqa: F401
    ReplayBuffer, buffer_add, buffer_can_sample, buffer_init, buffer_sample,
)
