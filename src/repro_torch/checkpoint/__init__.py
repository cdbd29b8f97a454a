"""Checkpoints in the JAX package's on-disk layout."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, SignalHandler, load_aux, load_extra, load_pytree,
    save_pytree,
)
