"""deepseek-coder-33b [dense] — arXiv:2401.14196 (llama-arch).

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab_size=32256,
    norm="rmsnorm", act="silu",
    fsdp=True,                        # 66 GB bf16 params
)

SMOKE = CONFIG.replace(
    name="deepseek-coder-smoke", n_layers=3, d_model=64, n_heads=8,
    n_kv_heads=2, d_ff=160, vocab_size=512, fsdp=False,
)
