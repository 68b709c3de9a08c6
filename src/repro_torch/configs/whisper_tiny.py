"""whisper-tiny [audio] — arXiv:2212.04356 (enc-dec transformer backbone).

4L enc + 4L dec, d_model=384 6H (MHA kv=6) d_ff=1536 vocab=51865.
The conv/mel frontend is a STUB: ``input_specs()`` supplies precomputed
frame embeddings (B, 1500, 384).  Decoder positions are learned; the
assigned decode shapes extend the position table to 32k (synthetic).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    encoder_layers=4, encoder_seq=1500,
    norm="layernorm", act="gelu_mlp",
    max_seq_len=32768,
)

SMOKE = CONFIG.replace(
    name="whisper-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab_size=512, encoder_layers=2, encoder_seq=24,
    max_seq_len=128,
)
