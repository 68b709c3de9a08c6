"""Models of the port: every family of ``registry.MODEL_FAMILIES``."""

from repro_torch.models.registry import build_model, forward_logits  # noqa: F401
