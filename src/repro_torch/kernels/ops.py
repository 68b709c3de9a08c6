"""Public kernel wrappers (the API the rest of the port calls)."""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import status as kernel_status  # noqa: F401
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_gqa, flash_decode, flash_decode_gqa)
from repro_torch.kernels.mandelbrot import mandelbrot  # noqa: F401
from repro_torch.kernels.rwkv6_scan import (  # noqa: F401
    wkv6, wkv6_batched, wkv6_batched_train, wkv6_decode)
from repro_torch.kernels.spin_image import spin_image  # noqa: F401


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """Multi-head convenience: q, k (B, S, H, D), v (B, S, H, Dv) ->
    (B, S, H, Dv), read in place (the reference folds the heads into the
    batch first)."""
    return flash_attention_gqa(q, k, v, causal=causal)
