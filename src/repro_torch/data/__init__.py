"""Experience storage of the port (``repro.data`` subset): the replay
ring of the whole population."""
from repro_torch.data.replay_buffer import (  # noqa: F401
    ReplayBuffer, buffer_add, buffer_can_sample, buffer_init, buffer_sample,
)
