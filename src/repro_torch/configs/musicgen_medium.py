"""musicgen-medium [audio] — decoder-only over EnCodec tokens.

48L d_model=1536 24H (GQA kv=24) d_ff=6144 vocab=2048 [arXiv:2306.05284; hf]
Backbone only: the EnCodec frontend is a stub — the batch carries
precomputed frame embeddings (B,S,1536) under ``"embeds"``; the head is
the 2048-way codebook.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="musicgen-medium",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    activation="gelu",              # MusicGen uses GELU MLPs
    frontend="audio_frames",
)
