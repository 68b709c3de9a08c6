"""Model registry: ModelConfig.family -> model class."""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

MODEL_FAMILIES = ("dense", "moe", "vlm", "encdec", "rwkv", "hybrid")
_NOT_PORTED = {
    "moe": "mixture-of-experts transformers (repro.models.transformer)",
    "vlm": "the vision-language transformer (repro.models.transformer)",
    "encdec": "the encoder-decoder (repro.models.whisper)",
    "hybrid": "the attention+SSM hybrid (repro.models.ssm)",
}


def build_model(cfg: ModelConfig):
    if cfg.family == "dense":
        from repro_torch.models.transformer import TransformerModel
        return TransformerModel(cfg)
    if cfg.family == "rwkv":
        from repro_torch.models.rwkv6 import RWKV6Model
        return RWKV6Model(cfg)
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{_NOT_PORTED[cfg.family]} is not ported to repro_torch yet: "
            f"ROADMAP.md queue A, item A6")
    raise ValueError(f"unknown family {cfg.family!r}")
