"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, shared+routed experts.

27L d_model=2048 16H d_ff=1408 (per-expert) vocab=102400, MoE 64e top-6
[arXiv:2405.04434; hf]. 64 routed experts, top-6, +2 shared, as the JAX
package's config has them; the first layer is dense as in the released
model.
"""
from repro_torch.configs.base import LMConfig, MLASpec, MoESpec

CONFIG = LMConfig(
    name="deepseek-v2-lite-16b",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    moe=MoESpec(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                first_dense_layers=1),
    mla=MLASpec(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_dim=128),
)
