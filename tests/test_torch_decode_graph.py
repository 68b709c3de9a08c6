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
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core import trace as trc
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
    """On the CPU a capturable model's groups of many steps lease no lane
    and capture nothing: they walk the int-position loop, to the
    per-token loop's tokens."""
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
    """The static-buffer step (the one a graph captures) runs only in a
    graphed group: a group that is not graphed, capturable model or not,
    calls ``model.decode_step`` (the instance's attribute) exactly
    max_new - 1 times after its prefill, at the int positions
    S .. S + max_new - 2, to the per-token loop's tokens."""
    cfg = get_smoke(arch).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device=CPU)
    step, positions = model.decode_step, []

    def spy(*args):
        positions.append(args[3])
        return step(*args)
    monkeypatch.setattr(model, "decode_step", spy)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 5)).astype(np.int32)
    got = FusedGenerator(model)(params, prompts, 5)
    assert positions == [5, 6, 7, 8]
    assert all(type(p) is int for p in positions)
    want = greedy_decode_group(model, params, step, prompts, 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("replays", [0, 1, 5])
def test_capture_tally_adds_once_per_replay(replays):
    """Launches counted while a thread captures go to its tally, not to
    the counts, and each replay adds them once (variants too); each
    still records its "cuda" path and variant, and another thread's
    launches meanwhile count as launched."""
    site, other = "tally_site", "tally_other"
    before = dispatch.launches(site), dispatch.launches(other)
    var_before = dispatch.variant_launches(site).get("v", 0)
    with dispatch.capturing() as tally:
        for _ in range(3):
            dispatch.count_launch(site)
            assert dispatch.status(site) == {"path": "cuda"}
        dispatch.count_launch(site, "v")
        t = threading.Thread(target=dispatch.count_launch, args=(other,))
        t.start()
        t.join()
        assert dispatch.launches(site) == before[0]
        assert dispatch.status(site) == {"path": "cuda", "variant": "v"}
    assert tally.counts == {(site, None): 3, (site, "v"): 1}
    assert dispatch.launches(other) == before[1] + 1
    dispatch.count_launch(site)                 # outside: counted
    for _ in range(replays):
        tally.replayed()
    assert dispatch.launches(site) == before[0] + 1 + 4 * replays
    assert (dispatch.variant_launches(site).get("v", 0)
            == var_before + replays)


# --------------------------------------------- graphs kept across groups
class EagerGraph:
    """Stands in for a CUDA graph on the CPU: a replay runs the captured
    step eagerly."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        self.step()


@pytest.fixture
def kept_path(monkeypatch):
    """The graphed path on the CPU: every capturable group of
    ``GRAPH_MIN_STEPS`` steps or more leases a lane (fresh lanes for the
    test), and a capture records ``n_layers`` flash_decode launches into
    its tally and returns an :class:`EagerGraph` (the capture runs
    nothing, as on the card); the tests' model is :func:`smoke_model`'s."""
    monkeypatch.setattr(serve_executor, "_free_lanes", {})
    monkeypatch.setattr(FusedGenerator, "graphed",
                        lambda self, device, steps: steps >= GRAPH_MIN_STEPS)
    n_layers = get_smoke("olmo-1b").n_layers

    def capture(step, lane):
        with dispatch.capturing() as tally:
            for _ in range(n_layers):
                dispatch.count_launch("flash_decode")
        return EagerGraph(step), tally
    monkeypatch.setattr(serve_executor, "_capture", capture)
    dispatch.reset_launches()
    return serve_executor._free_lanes


def smoke_model():
    cfg = get_smoke("olmo-1b").replace(dtype="float32")
    model = build_model(cfg)
    return cfg, model, model.init(0, device=CPU)


def prompts_of(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("total", [1, 2, 24, 63, 64, 65, 100, 128, 129,
                                   300, 544, 1024, 1025, 2100])
def test_cache_capacity_is_a_function_of_the_group_shape(total):
    """The kept cache's slots: a power of two, at least the group's
    positions and the floor, the least such, the same on every call (no
    lane or group enters it)."""
    cap = serve_executor.cache_capacity(total)
    assert cap >= total and cap >= serve_executor.CAPACITY_FLOOR
    assert cap & (cap - 1) == 0
    assert cap == serve_executor.CAPACITY_FLOOR or cap // 2 < total
    assert all(serve_executor.cache_capacity(total) == cap
               for _ in range(3))


def test_decode_mix_takes_five_capacities():
    """The decode cell's groups (S 16..512, 8..32 new tokens, so S +
    max_new 24..544) fall in five capacities."""
    caps = {serve_executor.cache_capacity(S + n)
            for S in range(16, 513) for n in range(8, 33)}
    assert caps == {64, 128, 256, 512, 1024}


class _CountingModel:
    """Stands in for a model: counts the caches it allocates."""

    def __init__(self):
        self.made = []

    def init_cache(self, batch, max_len, *, device=None):
        self.made.append((batch, max_len))
        return {"k": torch.zeros(batch, max_len)}


def test_lane_store_keys_hits_and_drops():
    """A lane keeps one state per (rows, capacity) of one (model,
    params): the same key gives the same state (its cache allocated
    once), another key another, and another params or model drops every
    state kept for the old one."""
    lane = serve_executor._Lane(CPU)
    model, params, other = _CountingModel(), object(), object()
    a = lane.state(model, params, (1, 64), CPU)
    assert lane.state(model, params, (1, 64), CPU) is a
    b = lane.state(model, params, (2, 64), CPU)
    assert b is not a and model.made == [(1, 64), (2, 64)]
    assert lane.holds(model, params, (1, 64))
    assert not lane.holds(model, other, (1, 64))
    a.graph = EagerGraph(lambda: None)
    c = lane.state(model, other, (1, 64), CPU)
    assert c is not a and c.graph is None
    assert list(lane.kept) == [(1, 64)] and lane.owner[1] is other
    assert not lane.holds(model, params, (1, 64))
    model2 = _CountingModel()
    lane.state(model2, other, (1, 128), CPU)
    assert list(lane.kept) == [(1, 128)] and lane.owner[0] is model2


def test_lease_prefers_the_lane_that_keeps_the_key(monkeypatch):
    """A lease takes a free lane holding state for its key over the
    others, else the last freed, else a new lane; every lane returns."""
    monkeypatch.setattr(serve_executor, "_free_lanes", {})
    model, params = _CountingModel(), object()
    lease = serve_executor._lane
    with lease(CPU, model, params, (1, 64)) as first, \
            lease(CPU, model, params, (1, 64)) as second:
        assert first is not second
    first.state(model, params, (1, 64), CPU)
    with serve_executor._lane(CPU, model, params, (1, 64)) as got:
        assert got is first
    with serve_executor._lane(CPU, model, params, (1, 128)) as got:
        assert got is first                     # the last freed
    with serve_executor._lane(CPU, model, params, (1, 64)) as a:
        with serve_executor._lane(CPU, model, params, (1, 64)) as b:
            assert a is first and b is second
            with serve_executor._lane(CPU, model, params, (1, 64)) as c:
                assert c not in (first, second)
    assert len(serve_executor._free_lanes[CPU]) == 3


@pytest.mark.parametrize("B", [1, 3])
def test_kept_state_serves_a_shorter_group_as_a_fresh_one(kept_path, B):
    """A longer group, then a shorter one of the same rows and capacity,
    through one lane's kept cache: each group's tokens are a fresh
    generator's; the second replays the first's graph from step 1 (one
    capture, one hit); the valid slots of the kept cache equal, bit for
    bit, those of a fresh lane that served the shorter group alone, the
    longer group's slots beyond them left as they were and never read."""
    cfg, model, params = smoke_model()
    long_p, short_p = prompts_of(cfg, B, 30, 1), prompts_of(cfg, B, 9, 2)
    cap = serve_executor.cache_capacity(30 + 20)
    assert serve_executor.cache_capacity(9 + 7) == cap
    fresh = FusedGenerator(model)
    fresh.graphed = lambda device, steps: False
    gen = FusedGenerator(model)
    for p, n in ((long_p, 20), (short_p, 7)):
        np.testing.assert_array_equal(gen(params, p, n), fresh(params, p, n))
    assert dispatch.events(serve_executor.GRAPH_CAPTURES) == 1
    assert dispatch.events(serve_executor.GRAPH_HITS) == 1
    (lane,) = kept_path[CPU]
    rows = serve_executor._pad_pow2(B)
    kept = lane.kept[(rows, cap)]
    kept_path.clear()
    gen(params, short_p, 7)
    (alone,) = kept_path[CPU]
    ref = alone.kept[(rows, cap)]
    n_valid = 9 + 7 - 1                 # the last token is never fed back
    for a, b in zip(kept.cache["dense"], ref.cache["dense"]):
        assert torch.equal(a["k"][:, :n_valid], b["k"][:, :n_valid])
        assert torch.equal(a["v"][:, :n_valid], b["v"][:, :n_valid])
        assert torch.equal(a["pos"][:n_valid], b["pos"][:n_valid])
        assert a["pos"][n_valid:30 + 19].tolist() == list(
            range(n_valid, 30 + 19))
        assert (b["pos"][n_valid:] == -1).all()


def test_capture_tally_is_added_per_replay_in_later_groups(kept_path):
    """The launches counted while capturing are kept with the graph and
    added once a replay, in the group that captured (steps 2 .. n - 1)
    and in each later group that replays it (steps 1 .. n - 1)."""
    cfg, model, params = smoke_model()
    gen = FusedGenerator(model)
    news = (9, 5, 12)
    for i, n in enumerate(news):
        gen(params, prompts_of(cfg, 1, 6 + i, i), n)
    assert dispatch.events(serve_executor.GRAPH_CAPTURES) == 1
    assert dispatch.events(serve_executor.GRAPH_HITS) == 2
    replays = (news[0] - 2) + (news[1] - 1) + (news[2] - 1)
    assert dispatch.launches("flash_decode") == cfg.n_layers * replays
    dispatch.reset_launches()
    assert dispatch.events() == {}


def test_kept_graph_spans_tell_capture_from_hit(kept_path):
    """Under a chunk context a capture and a hit are each one EV_GRAPH
    row, told apart by its detail, its size the group's replayed steps;
    a hit's row comes before its first step."""
    cfg, model, params = smoke_model()
    gen = FusedGenerator(model)
    rec = trc.TraceRecorder()
    ctx = trc.ChunkContext(rec, time.monotonic(), 0)
    for i, n in enumerate((8, 6)):
        ctx.run(i, i, gen, params, prompts_of(cfg, 1, 7, i), n)
    tr = rec.finalize()
    graphs = np.flatnonzero(tr.kind == trc.EV_GRAPH)
    assert [tr.details.get(int(g)) for g in graphs] == ["capture", "hit"]
    assert tr.size[graphs].tolist() == [8 - 2, 6 - 1]
    second = np.flatnonzero(tr.seq == 1)
    assert tr.kind[second].tolist() == ([trc.EV_PREFILL, trc.EV_GRAPH]
                                        + [trc.EV_STEP] * 5)
    n_steps = int((tr.kind == trc.EV_STEP).sum())
    assert tr.size[graphs].sum() / n_steps == (6 + 5) / (7 + 5)


def test_a_duplicate_on_another_lane_keeps_the_key(kept_path):
    """The same request served while its lane is leased goes to another
    lane under the same (rows, capacity), captures there, and gives the
    same tokens."""
    cfg, model, params = smoke_model()
    gen = FusedGenerator(model)
    p = prompts_of(cfg, 1, 11, 3)
    first = gen(params, p, 6)
    (lane,) = kept_path[CPU]
    key = (1, serve_executor.cache_capacity(11 + 6))
    with serve_executor._lane(CPU, model, params, key) as held:
        assert held is lane
        np.testing.assert_array_equal(gen(params, p, 6), first)
    assert len(kept_path[CPU]) == 2
    assert all(list(ln.kept) == [key] for ln in kept_path[CPU])
    assert dispatch.events(serve_executor.GRAPH_CAPTURES) == 2


def test_graph_reuse_share_reads_the_counters():
    """The benchmark's ``graph_reuse_share``: hits over graphed groups in
    %, None where no group was graphed."""
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "portbench"
            / "metrics" / "graph_reuse_share.py")
    spec = importlib.util.spec_from_file_location("graph_reuse_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    dispatch.reset_launches()
    assert mod.compute({}) is None
    for _ in range(3):
        dispatch.count_event(serve_executor.GRAPH_HITS)
    dispatch.count_event(serve_executor.GRAPH_CAPTURES)
    assert mod.compute({}) == 75.0
    dispatch.reset_launches()
    assert mod.compute({}) is None
