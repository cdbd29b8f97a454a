"""gemma-7b [dense] — GeGLU, head_dim=256.

28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000
[arXiv:2403.08295; hf].  Embeddings scaled by sqrt(d_model), tied head.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="gemma-7b",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
    d_ff=24576, vocab_size=256000, head_dim=256,
    activation="gelu", scale_embeddings=True, tie_embeddings=True,
)
