"""pixtral-12b [vlm] — pixtral-ViT + mistral-nemo decoder backbone.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified].  Backbone only: the ViT is a
stub — the batch carries precomputed patch embeddings for a 256-position
image prefix under ``"patch_embeds"``.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="pixtral-12b",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128, rope_theta=1e9,
    frontend="vision_patches", num_frontend_positions=256,
)
