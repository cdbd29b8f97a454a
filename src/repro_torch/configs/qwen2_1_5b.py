"""qwen2-1.5b [dense] — GQA with QKV bias.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936 [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen2-1.5b",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, qkv_bias=True, rope_theta=1e6,
    tie_embeddings=True,
)
