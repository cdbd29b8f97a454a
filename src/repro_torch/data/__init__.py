"""Data of the port (``repro.data`` subset): the replay ring of the whole
population and the synthetic LM token pipeline."""
from repro_torch.data.lm_pipeline import (  # noqa: F401
    host_batches, synthetic_token_stream,
)
from repro_torch.data.replay_buffer import (  # noqa: F401
    ReplayBuffer, buffer_add, buffer_can_sample, buffer_init, buffer_sample,
)
