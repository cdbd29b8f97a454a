"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64
[arXiv:2411.15242; unverified].  One weight-shared attention+MLP block is
invoked every 6 Mamba2 layers (13 full super-blocks + a 3-layer tail);
each invocation has its own KV cache.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="zamba2-7b",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    block_type="mamba2", ssm_state=64, ssm_head_dim=64,
    shared_attn_every=6,
    ssm_chunk=256,
)
