"""Device selection: the port runs on the card unless asked otherwise."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None
            ) -> torch.device:
    """``None`` -> ``cuda``.  Raises when a CUDA device is asked for and
    none is present: there is no silent CPU fallback — pass
    ``device="cpu"`` to run the plain PyTorch versions on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA GPU by default, and no GPU is "
            "available; pass device='cpu' to run on the CPU")
    return dev
