"""deepseek-v2-lite-16b [moe] — arXiv:2405.04434 / HF DeepSeek-V2-Lite.

27L d_model=2048 16H, MLA (kv_lora=512, no q-lora, rope=64 nope=128 v=128),
2 shared + 64 routed experts top-6 (d_expert=1408), first layer dense
(d_ff=10944), vocab=102400.  The assignment note "160 routed" contradicts
the 64e field; we follow `MoE 64e top-6` (= the HF config).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    moe=True, n_routed_experts=64, n_shared_experts=2, top_k=6,
    d_expert=1408, n_dense_layers=1,
    mla=True, kv_lora_rank=512, q_lora_rank=0,
    rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
    norm="rmsnorm", act="silu",
)

SMOKE = CONFIG.replace(
    name="deepseek-v2-lite-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=160, vocab_size=512,
    n_routed_experts=8, n_shared_experts=2, top_k=2, d_expert=32,
    n_dense_layers=1, kv_lora_rank=16, rope_head_dim=8,
    nope_head_dim=16, v_head_dim=16,
)
