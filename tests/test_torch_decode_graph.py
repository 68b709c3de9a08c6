"""What the serving executor's CUDA graph of a decode step rests on, on
the CPU: the decode step at a position held in a device tensor against
the same step at an int position, which models declare their step
capturable, that ``FusedGenerator`` walks its loop from Python off the
card, and the launch tally of a capture (``kernels.dispatch``).  The
graph itself is captured and replayed only on the card
(``scripts/torch_decode_graph.py``).

Tolerance: none.  The two forms of the position run the same ops, so
outputs and caches are compared bit for bit.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.kernels import dispatch
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models.common import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import serve_executor
from repro_torch.runtime.serve_executor import (GRAPH_MIN_STEPS,
                                                FusedGenerator,
                                                greedy_decode_group)

CPU = torch.device("cpu")
DENSE = ModelConfig(family="dense", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, d_ff=128, vocab_size=128, dtype="float32")
#: the archs whose every layer is dense GQA
CAPTURABLE = {"olmo-1b", "qwen3-4b", "qwen2-72b", "deepseek-coder-33b"}


def caches_equal(a, b) -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            caches_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            caches_equal(x, y)
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("window", [0, 4])
def test_gqa_decode_tensor_position_equals_int(window, B):
    """Steps 0 .. 9 at an int and at a 0-dim int32 tensor position give
    the same output, K/V cache and slot positions, a rolling window of 4
    slots wrapping twice."""
    params = init_params(attn.gqa_specs(DENSE), seed=0, device=CPU)
    n = 10
    caches = [attn.gqa_init_cache(DENSE, B, n, window=window, device=CPU)
              for _ in range(2)]
    xs = torch.randn((n, B, 1, DENSE.d_model),
                     generator=torch.Generator().manual_seed(1))
    for pos in range(n):
        a, _ = attn.gqa_decode(params, DENSE, xs[pos], caches[0], pos,
                               window=window)
        b, _ = attn.gqa_decode(params, DENSE, xs[pos], caches[1],
                               torch.tensor(pos, dtype=torch.int32),
                               window=window)
        assert torch.equal(a, b)
        caches_equal(caches[0], caches[1])
    # slot s holds the last position written there: pos % 4 when rolling
    slots = caches[0]["pos"].tolist()
    assert slots == ([8, 9, 6, 7] if window else list(range(n)))


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-4b", "qwen2-72b"])
def test_decode_step_tensor_position_equals_int(arch):
    """``TransformerModel.decode_step`` after a prefill, 4 steps at int
    positions against 4 at a device position that the caller advances in
    place, as a graph replay does: logits and caches bit for bit (olmo's
    non-parametric LN, qwen3's qk-norm, qwen2's QKV bias)."""
    cfg = get_smoke(arch).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    B, S, new = 2, 5, 4
    prompt = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(2))
    caches = [model.init_cache(B, S + new, device=CPU) for _ in range(2)]
    toks = []
    for c in caches:
        logits, _ = model.prefill(params, c, prompt)
        toks.append(torch.argmax(logits[:, -1, :], dim=-1)[:, None])
    pos = torch.tensor(S, dtype=torch.int32)
    with torch.inference_mode():
        for i in range(new):
            a, _ = model.decode_step(params, caches[0], toks[0], S + i)
            b, _ = model.decode_step(params, caches[1], toks[1], pos)
            pos.add_(1)
            assert torch.equal(a, b)
            caches_equal(caches[0], caches[1])
            toks = [torch.argmax(x[:, -1, :], dim=-1)[:, None]
                    for x in (a, b)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_graph_capability_is_dense_gqa_only(arch):
    """Only a model whose every layer is dense GQA declares its decode
    step capturable (not MoE, MLA, the vlm, rwkv6, hymba or whisper), and
    the generator graphs a group only on the card and from
    ``GRAPH_MIN_STEPS`` steps on."""
    model = build_model(get_smoke(arch))
    want = arch in CAPTURABLE
    assert getattr(model, "decode_capturable", False) is want
    gen = FusedGenerator(model)
    cuda = torch.device("cuda", 0)
    assert gen.graphed(cuda, GRAPH_MIN_STEPS) is want
    assert gen.graphed(cuda, 31) is want
    assert not gen.graphed(cuda, GRAPH_MIN_STEPS - 1)
    assert not gen.graphed(CPU, 31)
    assert not gen.graphed(torch.device("meta"), 31)


@pytest.mark.parametrize("B", [1, 3])
def test_fused_generator_on_cpu_never_graphs(B, monkeypatch):
    """On the CPU a capturable model's groups of many steps run the
    static-buffer step uncaptured, to the per-token loop's tokens."""
    model = build_model(DENSE)
    assert model.decode_capturable
    params = model.init(0, device=CPU)

    def refuse(*args, **kw):
        raise AssertionError("graph path taken on the CPU")
    monkeypatch.setattr(serve_executor, "_capture", refuse)
    monkeypatch.setattr(serve_executor, "_lane", refuse)
    prompts = np.random.default_rng(B).integers(
        0, DENSE.vocab_size, size=(B, 6)).astype(np.int32)
    got = FusedGenerator(model)(params, prompts, 9)
    want = greedy_decode_group(model, params, model.decode_step, prompts, 9)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-1.6b", "hymba-1.5b"])
def test_static_step_is_the_capturable_models_only(arch, monkeypatch):
    """The static-buffer step (the one a graph captures) runs a model's
    decode steps exactly where the model declares them capturable; the
    others keep the loop at int positions."""
    cfg = get_smoke(arch).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    ran = []
    static = FusedGenerator._static_steps

    def spy(self, *args):
        ran.append(True)
        return static(self, *args)
    monkeypatch.setattr(FusedGenerator, "_static_steps", spy)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 5)).astype(np.int32)
    got = FusedGenerator(model)(params, prompts, 5)
    assert bool(ran) is (arch in CAPTURABLE)
    want = greedy_decode_group(model, params, model.decode_step, prompts, 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("replays", [0, 1, 5])
def test_capture_tally_adds_once_per_replay(replays):
    """Launches counted while a thread captures go to its tally, not to
    the counts, and each replay adds them once (variants too); paths
    are recorded as always, and another thread's launches meanwhile
    count as launched."""
    site, other = "tally_site", "tally_other"
    before = dispatch.launches(site), dispatch.launches(other)
    var_before = dispatch.variant_launches(site).get("v", 0)
    with dispatch.capturing() as tally:
        for _ in range(3):
            dispatch.count_launch(site)
            dispatch.record(site, "cuda")
        dispatch.count_launch(site, "v")
        t = threading.Thread(target=dispatch.count_launch, args=(other,))
        t.start()
        t.join()
        assert dispatch.launches(site) == before[0]
        assert dispatch.status(site) == {"path": "cuda"}
    assert tally.counts == {(site, None): 3, (site, "v"): 1}
    assert dispatch.launches(other) == before[1] + 1
    dispatch.count_launch(site)                 # outside: counted
    for _ in range(replays):
        tally.replayed()
    assert dispatch.launches(site) == before[0] + 1 + 4 * replays
    assert (dispatch.variant_launches(site).get("v", 0)
            == var_before + replays)
