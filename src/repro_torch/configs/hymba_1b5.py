"""hymba-1.5b [hybrid] — arXiv:2411.13676 (parallel attn + mamba heads).

32L d_model=1600 25H (GQA kv=5, head_dim=64) d_ff=5504 vocab=32001,
ssm_state=16, 128 meta tokens, SWA(1024) everywhere except 3 global
layers (first/middle/last).  Sub-quadratic => long_500k applicable.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, ssm_conv=4, ssm_expand=2.0,
    sliding_window=1024, n_meta_tokens=128,
    global_layers=(0, 15, 31),
    norm="rmsnorm", act="silu",
)

SMOKE = CONFIG.replace(
    name="hymba-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=160, vocab_size=512, ssm_state=4,
    sliding_window=16, n_meta_tokens=4, global_layers=(1,),
)
