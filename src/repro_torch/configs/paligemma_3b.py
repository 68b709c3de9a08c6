"""paligemma-3b [vlm] — arXiv:2407.07726 (SigLIP + gemma-2b backbone).

18L d_model=2048 8H (MQA kv=1, head_dim=256) d_ff=16384 vocab=257216.
The SigLIP frontend is a STUB: ``input_specs()`` supplies precomputed patch
embeddings (B, 256, 2048); the backbone applies a linear adapter and a
prefix-LM mask (patches attend bidirectionally).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_head=256,
    d_ff=16384, vocab_size=257216,
    n_patch_tokens=256, tie_embeddings=True,
    norm="rmsnorm", act="gelu",
)

SMOKE = CONFIG.replace(
    name="paligemma-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
    d_head=16, d_ff=160, vocab_size=512, n_patch_tokens=8,
)
