"""Models of the port: the dense transformer and RWKV-6 (serving)."""

from repro_torch.models.registry import build_model  # noqa: F401
