"""qwen3-moe-30b-a3b [moe] — 128 experts top-8.

48L d_model=2048 32H (GQA kv=4) d_ff=768 (per-expert) vocab=151936
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import LMConfig, MoESpec

CONFIG = LMConfig(
    name="qwen3-moe-30b-a3b",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6,
    moe=MoESpec(num_experts=128, top_k=8, d_expert=768),
)
