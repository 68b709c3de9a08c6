"""Model registry: ModelConfig.family -> model class."""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

MODEL_FAMILIES = ("dense", "moe", "vlm", "encdec", "rwkv", "hybrid")


def build_model(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import TransformerModel
        return TransformerModel(cfg)
    if cfg.family == "encdec":
        from repro_torch.models.whisper import WhisperModel
        return WhisperModel(cfg)
    if cfg.family == "rwkv":
        from repro_torch.models.rwkv6 import RWKV6Model
        return RWKV6Model(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.ssm import HymbaModel
        return HymbaModel(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")


def forward_logits(model, params, batch: dict):
    """(B, S, V) logits of ``model.forward`` on a batch of
    ``configs.smoke_batch``'s keys, for every family's signature:
    whisper takes the frames, the vlm family its patches; whisper and
    hymba return the logits alone, the others a tuple led by them."""
    fam = model.cfg.family
    if fam == "encdec":
        return model.forward(params, batch["tokens"], batch["frames"])
    if fam == "hybrid":
        return model.forward(params, batch["tokens"])
    if fam == "rwkv":
        return model.forward(params, batch["tokens"])[0]
    return model.forward(params, batch["tokens"], batch.get("patches"))[0]
