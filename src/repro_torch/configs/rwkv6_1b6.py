"""rwkv6-1.6b [ssm] — arXiv:2404.05892 "Finch" (attention-free).

24L d_model=2048 (32 wkv heads of 64) d_ff=7168 vocab=65536.
Data-dependent decay; O(1)-state decode => long_500k applicable.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="rwkv",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab_size=65536,
    rwkv_head_dim=64,
)

SMOKE = CONFIG.replace(
    name="rwkv6-smoke", n_layers=2, d_model=64, d_ff=160, vocab_size=512,
    rwkv_head_dim=16,
)
