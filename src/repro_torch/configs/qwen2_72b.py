"""qwen2-72b [dense] — arXiv:2407.10671 (GQA, QKV bias).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    qkv_bias=True,
    norm="rmsnorm", act="silu",
    rope_theta=1_000_000.0,
    fsdp=True,                        # 144 GB bf16 params
)

SMOKE = CONFIG.replace(
    name="qwen2-smoke", n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab_size=512, fsdp=False,
)
