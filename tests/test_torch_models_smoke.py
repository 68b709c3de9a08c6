"""Per-architecture smoke tests of the port (reduced configs, CPU), the
twin of tests/test_models_smoke.py over all ten architectures: one
training step, output shapes, finite values, decode; decode-vs-forward
parity; and the full configs' parameter trees against the reference's.

Tolerances: decode against forward 1e-4 absolute + 1e-3 relative, as in
the reference's test (float32, dropless MoE capacity).  The full configs'
parameter shapes and dtypes equal the reference's exactly.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.registry import modality_inputs as jmodality_inputs
from repro.models import build_model as jbuild
from repro.models.common import param_count as jparam_count
from repro_torch import optim
from repro_torch.configs import (ARCH_IDS, get_config, get_smoke,
                                 modality_inputs, smoke_batch)
from repro_torch.models import build_model, forward_logits
from repro_torch.models.common import (ParamSpec, param_count,
                                       tree_leaves)
from repro_torch.runtime.executor import value_and_grad


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small shapes: one intra-op thread (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step(arch):
    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = smoke_batch(cfg, device="cpu")
    loss, grads = value_and_grad(lambda p, b: model.loss(p, b)[0], params,
                                 batch)
    assert torch.isfinite(loss), f"{arch}: non-finite loss {loss}"
    assert all(bool(torch.isfinite(g.float()).all())
               for g in tree_leaves(grads)), f"{arch}: non-finite grads"
    opt = optim.make_optimizer("adamw", lr=1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    new_params = optim.apply_updates(params, updates)
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(params), tree_leaves(new_params)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_shapes(arch):
    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = smoke_batch(cfg, batch=2, seq=16, device="cpu")
    with torch.no_grad():
        logits = forward_logits(model, params, batch)
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_decode_runs(arch):
    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    B, L = 2, 24
    with torch.inference_mode():
        cache = model.init_cache(B, L, device="cpu")
        if cfg.family == "encdec":
            batch = smoke_batch(cfg, batch=B, device="cpu")
            cache = model.prefill_cross(params, cache, batch["frames"])
        tok = torch.zeros((B, 1), dtype=torch.int64)
        for pos in range(3):
            logits, cache = model.decode_step(params, cache, tok, pos)
            assert logits.shape == (B, 1, cfg.vocab_size)
            assert bool(torch.isfinite(logits.float()).all())
            tok = torch.argmax(logits[:, -1:, :], dim=-1)


@pytest.mark.parametrize("arch", ["qwen3-4b", "olmo-1b",
                                  "deepseek-v2-lite-16b", "rwkv6-1.6b",
                                  "hymba-1.5b"])
def test_decode_matches_forward(arch):
    """Greedy decode logits == full-forward logits at the same positions
    (float32, dropless MoE capacity: capacity drops legitimately differ
    between the forward's and decode's token groups)."""
    cfg = get_smoke(arch).replace(dtype="float32", capacity_factor=8.0)
    model = build_model(cfg)
    params = model.init(1, device="cpu")
    B, S = 2, 8
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    with torch.inference_mode():
        full = forward_logits(model, params, {"tokens": tokens})
        cache = model.init_cache(B, S, device="cpu")
        if cfg.family == "hybrid":
            cache = model.prefill_meta(params, cache, B)
        outs = []
        for pos in range(S):
            logits, cache = model.decode_step(params, cache,
                                              tokens[:, pos:pos + 1], pos)
            outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(),
                               full.numpy(), atol=1e-4, rtol=1e-3)


def _spec_leaves(specs) -> list:
    if isinstance(specs, ParamSpec):
        return [specs]
    if isinstance(specs, list):
        return [x for s in specs for x in _spec_leaves(s)]
    return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]


def test_paper_config_parameter_counts():
    """Full configs land near their nameplate sizes (the reference's
    ranges)."""
    expect = {
        "deepseek-v3-671b": (600e9, 720e9),
        "deepseek-v2-lite-16b": (14e9, 18e9),
        "deepseek-coder-33b": (30e9, 36e9),
        "qwen3-4b": (3.2e9, 4.6e9),
        "olmo-1b": (1.0e9, 1.4e9),
        "qwen2-72b": (70e9, 75e9),
        "paligemma-3b": (2.2e9, 3.2e9),
        "whisper-tiny": (25e6, 60e6),
        "rwkv6-1.6b": (1.4e9, 1.8e9),
        "hymba-1.5b": (1.2e9, 1.8e9),
    }
    for arch, (lo, hi) in expect.items():
        n = param_count(build_model(get_config(arch)).param_specs())
        assert lo <= n <= hi, f"{arch}: {n / 1e9:.2f}B"
        assert n == jparam_count(jbuild(jget_config(arch)).param_specs())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_params_equal_the_reference(arch):
    """Full configs: the port's parameter specs, layers unstacked, have
    the reference's abstract parameters' shapes and dtypes, leaf for leaf
    in flatten order (no memory is allocated on either side)."""
    jabs = jax.tree_util.tree_leaves(jbuild(jget_config(arch)).abstract())
    specs = build_model(get_config(arch)).param_specs()
    got = []

    def walk(s):
        # a list of per-layer specs stands for one stacked reference leaf
        if isinstance(s, list):
            for leaf_specs in zip(*(_spec_leaves(x) for x in s)):
                got.append(((len(s),) + leaf_specs[0].shape,
                            leaf_specs[0].dtype))
            return
        if isinstance(s, ParamSpec):
            got.append((s.shape, s.dtype))
            return
        for k in sorted(s):
            walk(s[k])
    walk(specs)
    assert len(got) == len(jabs)
    for (shape, dtype), a in zip(got, jabs):
        assert tuple(shape) == tuple(a.shape)
        assert str(dtype).replace("torch.", "") == str(a.dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_cli_runs_every_arch(arch, capsys):
    """``launch.serve --arch <arch> --smoke --device cpu`` serves every
    request through a fail-stop (whisper, without ``prefill``, walks its
    prompts through ``decode_step``)."""
    from repro_torch.launch import serve as tserve
    stats = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--requests", "4", "--prompt-len", "5",
                         "--max-new-tokens", "2", "--fail-worker", "1"])
    assert stats.n_requests == 4 and not stats.hung
    assert "served 4/4 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-tiny",
                                  "olmo-1b"])
def test_modality_inputs_equal_the_reference(arch):
    """The frontend stubs' shapes and dtypes equal the reference's
    ``modality_inputs`` (meta tensors: no memory), full configs."""
    got = modality_inputs(get_config(arch), 3)
    want = jmodality_inputs(jget_config(arch), 3)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape)
        assert str(t.dtype).replace("torch.", "") == str(want[k].dtype)
