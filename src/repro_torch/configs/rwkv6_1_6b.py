"""rwkv6-1.6b [ssm] — Finch, data-dependent decay; attention-free.

24L d_model=2048 d_ff=7168 vocab=65536 [arXiv:2404.05892; unverified]
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="rwkv6-1.6b",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=7168, vocab_size=65536,
    block_type="rwkv6", ssm_head_dim=64,
    ssm_chunk=64,
)
