"""rwkv6-test [ssm] — tiny RWKV6 for CPU tests.

Same family/block structure as rwkv6-1.6b: 2L d_model=64 vocab=256, fp32
weights, no remat, chunk 16 so a 32-token prompt takes the chunked WKV path.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="rwkv6-test",
    num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
    d_ff=128, vocab_size=256,
    block_type="rwkv6", ssm_head_dim=32,
    ssm_chunk=16, dtype="float32", remat=False,
)
