"""qwen3-4b [dense] — HF Qwen/Qwen3-4B (qk-norm, GQA).

36L d_model=2560 32H (GQA kv=8, head_dim=128) d_ff=9728 vocab=151936.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=9728, vocab_size=151936,
    qk_norm=True, tie_embeddings=True,
    rope_theta=1_000_000.0,
    norm="rmsnorm", act="silu",
)

SMOKE = CONFIG.replace(
    name="qwen3-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=160, vocab_size=512,
)
