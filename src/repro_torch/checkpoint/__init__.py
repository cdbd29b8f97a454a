"""Checkpoints in the JAX package's on-disk layout."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, load_aux, load_extra, save_pytree,
)
