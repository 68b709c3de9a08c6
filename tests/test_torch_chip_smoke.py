"""``chip_smoke.py``'s model of the serving paths' decode caches.

The script holds flash_decode against its plain version at the slot
masks it expects each served request's last decode step to hand the
kernel (``served_valid``).  Here those masks are checked against the
ones the smoke configs' models really build, on the CPU: a request
through ``FusedGenerator`` with the same number of new tokens, the
masks caught at the decode op.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.runtime.serve_executor import FusedGenerator

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def expected_masks(cfg, p: int) -> list:
    """The masks phase 6 (and phase 2, for the dense family) times."""
    n = p + chip_smoke.SERVE_NEW
    served = chip_smoke.served_valid
    if cfg.family == "vlm":
        patch = cfg.n_patch_tokens
        return [served(n + patch, p, off=patch)]
    if cfg.family == "hybrid":
        meta, win = cfg.n_meta_tokens, cfg.sliding_window
        return [served(n + meta, p, off=meta),
                served(min(win, n + meta), p, off=meta, window=win)]
    return [served(n, p)]


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-tiny",
                                  "hymba-1.5b", "olmo-1b"])
@pytest.mark.parametrize("p", [5, 30])
def test_served_masks_are_the_models(arch, p, monkeypatch):
    cfg = get_smoke(arch).replace(dtype="float32")
    if cfg.family == "hybrid":
        # a window the 30-token request wraps (meta tokens are not fed)
        cfg = cfg.replace(sliding_window=24)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    seen = {}
    decode = attn.ops.flash_decode_gqa

    def spy(q, k, v, valid, **kw):
        seen[valid.numel()] = valid.clone()   # the last step's, per L
        return decode(q, k, v, valid, **kw)

    monkeypatch.setattr(attn.ops, "flash_decode_gqa", spy)
    FusedGenerator(model)(params, np.ones((1, p), np.int32),
                          chip_smoke.SERVE_NEW)
    for want in expected_masks(cfg, p):
        assert torch.equal(seen[want.numel()], want)
