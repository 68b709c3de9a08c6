"""olmo-1b [dense] — arXiv:2402.00838 (non-parametric LN, no biases).

16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=50304,
    norm="nonparam_ln", act="silu", tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="olmo-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab_size=512,
)
