"""``chip_smoke.py``'s pure helpers, on the CPU.

The script holds flash_decode against its plain version at the slot
masks it expects each served request's last decode step to hand the
kernel (``served_valid``).  Here those masks are checked against the
ones the smoke configs' models really build: a request through
``FusedGenerator`` with the same number of new tokens, the masks caught
at the decode op.

Phase 9 (the serving executor's four decode modes, its legacy surface)
is rehearsed at smoke size in float32: its requests, its launch
expectations, and its drive itself, the serving wrappers counting a
launch before their plain versions run as they count one on the card.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs import get_smoke
from repro_torch.kernels import dispatch, ops
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


# ------------------------------------------------------------ phase 9
def test_exec_requests_open_with_an_equal_length_pair():
    reqs = chip_smoke.exec_requests(100)
    assert [len(r.prompt) for r in reqs] == [37, 37, 64, 37, 37]
    assert all(r.max_new_tokens == chip_smoke.SERVE_NEW for r in reqs)
    assert all(np.array_equal(a.prompt, b.prompt) for a, b in
               zip(reqs, chip_smoke.exec_requests(100)))
    assert len(chip_smoke.exec_requests(100, 4)) == 4


def test_exec_launch_problems():
    """The mode table's expectations: n_layers launches of the prefill
    site a prefill call and of the decode site a decode step, no other
    site, no prefill in the per-token loop modes."""
    sites, L = ("flash_attention", "flash_decode"), 3
    fused = {"prefill": 2, "decode_step": 30}
    loop = {"prefill": 0, "decode_step": 100}
    check = chip_smoke.exec_launch_problems
    assert check(sites, L, True, fused,
                 {"flash_attention": 6, "flash_decode": 90}) == []
    assert check(sites, L, False, loop,
                 {"flash_decode": 300, "flash_attention": 0}) == []
    assert check(sites, L, True, fused,
                 {"flash_attention": 6, "flash_decode": 91})
    assert check(sites, L, False, loop,
                 {"flash_decode": 300, "flash_attention": 3})
    assert check(sites, L, False, fused,
                 {"flash_attention": 6, "flash_decode": 90})
    assert check(sites, L, True, fused, {"flash_attention": 6,
                                         "flash_decode": 90, "other": 1})
    assert check(sites, L, False, {"prefill": 0, "decode_step": 0}, {})


@pytest.fixture
def counted_launches(monkeypatch):
    """The serving wrappers count a launch, then run their plain
    versions (the CPU's path)."""
    for site, name in (("flash_attention", "flash_attention_gqa"),
                       ("flash_decode", "flash_decode_gqa"),
                       ("wkv6_batched", "wkv6_batched"),
                       ("wkv6_decode", "wkv6_decode")):
        def counting(*args, _fn=getattr(ops, name), _site=site, **kwargs):
            dispatch.count_launch(_site)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(ops, name, counting)


@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-1.6b"])
def test_exec_phase_at_smoke_size(arch, counted_launches, monkeypatch):
    """Phase 9's drive on a float32 smoke config, with prompts of 5 and 9
    tokens (in the script's order) and 4 new ones: each mode's fail-stop and failure-free runs
    (launches as the mode table expects, tokens equal), the same tokens
    across the four modes, groups of two only where batch_decode is on;
    the legacy cases on the dense config; the float32 cross-mode check
    on the smoke config in place of the full-width one."""
    monkeypatch.setattr(chip_smoke, "EXEC_PROMPTS", (5, 5, 9, 5, 5))
    monkeypatch.setattr(chip_smoke, "SERVE_NEW", 4)
    cfg = get_smoke(arch).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    calls = chip_smoke.ModelCalls(model)
    sizes = []
    call = FusedGenerator.__call__

    def spy(self, params, prompts, max_new):
        sizes.append(prompts.shape[0])
        return call(self, params, prompts, max_new)

    monkeypatch.setattr(FusedGenerator, "__call__", spy)
    tokens = {}
    for mode in chip_smoke.EXEC_MODES:
        sizes.clear()
        res = chip_smoke.exec_mode(model, params, calls, mode,
                                   chip_smoke.EXEC_SITES[arch])
        tokens[mode] = res["tokens"]
        assert chip_smoke.same_tokens(res["tokens"],
                                      tokens[(True, True)]) == []
        if mode[1]:
            assert (max(sizes) == 2) == mode[0], (mode, sizes)
    if cfg.family == "dense":
        chip_smoke.exec_legacy(model, params, calls, tokens)
    monkeypatch.setattr(configs, "get_config", get_smoke)
    launches = chip_smoke.exec_cross_mode(torch.device("cpu"), arch)
    prefill_site = chip_smoke.EXEC_SITES[arch][0]
    assert [n.get(prefill_site, 0) > 0 for n in launches.values()] \
        == [fused for _, fused in chip_smoke.EXEC_MODES]
