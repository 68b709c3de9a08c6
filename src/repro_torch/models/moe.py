"""Feed-forward blocks: the dense FFN of ``repro.models.moe`` that the
dense transformer uses.  Mixture-of-experts routing (``moe_specs``,
``moe_apply``) is not ported yet: ROADMAP.md queue A, item A6."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec


def ffn_specs(d_model: int, d_ff: int, act: str, dt) -> dict:
    s = {
        "up": ParamSpec((d_model, d_ff), dtype=dt),
        "down": ParamSpec((d_ff, d_model), dtype=dt),
    }
    if act in ("silu", "gelu"):          # gated (swiglu / geglu)
        s["gate"] = ParamSpec((d_model, d_ff), dtype=dt)
    return s


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def ffn_apply(p, x: torch.Tensor, act: str) -> torch.Tensor:
    up = x @ p["up"]
    if "gate" in p:
        g = x @ p["gate"]
        h = (F.silu(g) if act == "silu" else _gelu(g)) * up
    else:
        h = _gelu(up)
    return h @ p["down"]
