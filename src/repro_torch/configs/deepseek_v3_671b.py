"""deepseek-v3-671b [moe] — arXiv:2412.19437 / HF deepseek-ai/DeepSeek-V3.

61L d_model=7168 128H, MLA (kv_lora=512 q_lora=1536 rope=64 nope=128 v=128),
1 shared + 256 routed experts top-8 (d_expert=2048), first 3 layers dense
(d_ff=18432), vocab=129280, MTP.  ~671B total / ~37B active params.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,                       # dense-layer FFN (HF intermediate_size)
    vocab_size=129280,
    moe=True, n_routed_experts=256, n_shared_experts=1, top_k=8,
    d_expert=2048, n_dense_layers=3,
    mla=True, kv_lora_rank=512, q_lora_rank=1536,
    rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
    mtp=True, mtp_loss_coef=0.3,
    norm="rmsnorm", act="silu",
    fsdp=True,                        # 1.34 TB bf16 params: shard everything
)

SMOKE = CONFIG.replace(
    name="deepseek-v3-smoke", n_layers=5, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=160, vocab_size=512,
    n_routed_experts=8, n_shared_experts=1, top_k=2, d_expert=32,
    n_dense_layers=2, kv_lora_rank=16, q_lora_rank=24,
    rope_head_dim=8, nope_head_dim=16, v_head_dim=16, fsdp=False,
)
