"""What the serving executor's segmented prefill rests on, on the CPU:
rwkv6's padded segment against its one-shot prefill, the paths that pass
no count of real tokens, which models declare their prefill
segmentable, what a lane keeps for segments beside its decode state,
and ``FusedGenerator``'s segments replayed from graphs kept across
groups, with a stand-in graph that replays eagerly.  The graphs
themselves are captured and replayed only on the card
(``tests/test_torch_cuda.py``).

Tolerances: a segmented prefill against the one-shot prefill in
float32 within 1e-5 (absolute and relative): segments start on chunk
boundaries, so the recurrence chunks the prompt as one pass does, but
the padded last chunk and the segments' matrix products sum in another
order.  Padding itself is exact: a wholly padded chunk (k = 0, w = 1)
leaves the state bit for bit, and what the padded positions hold never
reaches the real ones.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core import trace as trc
from repro_torch.kernels import dispatch, ops
from repro_torch.kernels.rwkv6_scan import CHUNK
from repro_torch.models import build_model
from repro_torch.models import rwkv6
from repro_torch.runtime import serve_executor
from repro_torch.runtime.serve_executor import (PREFILL_CAPTURES,
                                                PREFILL_HITS, SEGMENT_LONG,
                                                SEGMENT_SHORT,
                                                FusedGenerator,
                                                prefill_segments)

CPU = torch.device("cpu")
TOL = dict(atol=1e-5, rtol=1e-5)
STATE = ("att_tok", "ffn_tok", "wkv")


class EagerGraph:
    """Stands in for a CUDA graph on the CPU: a replay runs the captured
    segment eagerly."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        self.step()


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke("rwkv6-1.6b").replace(dtype="float32")
    model = build_model(cfg)
    return cfg, model, model.init(0, device=CPU)


@pytest.fixture
def seg_path(monkeypatch, smoke):
    """The segmented path on the CPU: fresh lanes, every group segmented,
    and a capture that records ``n_layers`` wkv6_batched launches into
    its tally and returns an :class:`EagerGraph` (the capture runs
    nothing, as on the card)."""
    monkeypatch.setattr(serve_executor, "_free_lanes", {})
    monkeypatch.setattr(FusedGenerator, "segmented",
                        lambda self, device: True)
    n_layers = smoke[0].n_layers

    def capture(step, lane):
        with dispatch.capturing() as tally:
            for _ in range(n_layers):
                dispatch.count_launch("wkv6_batched")
        return EagerGraph(step), tally
    monkeypatch.setattr(serve_executor, "_capture", capture)
    dispatch.reset_launches()
    return serve_executor._free_lanes


def tokens_of(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def one_shot(model, params, toks):
    state = model.init_cache(toks.shape[0], 0, device=CPU)
    with torch.inference_mode():
        logits, _ = model.prefill(params, state, torch.from_numpy(toks))
    return logits, state


def segment(model, params, toks, C, state=None, fill=None):
    """One padded segment of C positions holding ``toks`` (B, n <= C)
    then ``fill`` (the padding's tokens; zeros by default), on ``state``
    (fresh by default) -> (logits, state)."""
    B, n = toks.shape
    if state is None:
        state = model.init_cache(B, 0, device=CPU)
    buf = torch.zeros((B, C), dtype=torch.int32)
    buf[:, :n] = torch.from_numpy(toks)
    if fill is not None:
        buf[:, n:] = torch.from_numpy(fill)
    with torch.inference_mode():
        logits, _ = model.prefill(
            params, dict(state, valid=torch.tensor(n, dtype=torch.int32)),
            buf)
    return logits, state


@pytest.mark.parametrize("S", [1, 31, 32, 33, 127, 128, 129, 255, 256, 257,
                               511, 512, 513, 700, 1023, 1024, 1025, 1100,
                               1281, 2040])
def test_segmented_prefill_equals_one_shot(S, smoke, seg_path):
    """The executor's segmented prefill (the last segment padded) of an
    S-token prompt at two rows, on a lane's state, against the one-shot
    prefill: the last position's logits and the three state tensors
    within 1e-5."""
    cfg, model, params = smoke
    toks = tokens_of(cfg, 2, S, S)
    want, state = one_shot(model, params, toks)
    lane = serve_executor._Lane(CPU)
    segs = lane.segments(model, params, 2, CPU)
    with torch.inference_mode():
        got, done = FusedGenerator(model)._prefill_segments(
            params, lane, segs, torch.from_numpy(toks))
    assert sum(done.values()) == len(prefill_segments(S))
    torch.testing.assert_close(got, want, **TOL)
    for k in STATE:
        torch.testing.assert_close(segs.state[k], state[k], **TOL)


@pytest.mark.parametrize("real", [CHUNK, 2 * CHUNK, 3 * CHUNK])
def test_a_padded_tail_leaves_the_state_bit_equal(real, smoke):
    """A segment of SEGMENT_SHORT positions whose first ``real`` (whole
    chunks) are real leaves the token shifts and the wkv state bit for
    bit as a one-shot prefill of the real tokens does, whatever its
    wholly padded chunks hold, and so do its logits."""
    cfg, model, params = smoke
    toks = tokens_of(cfg, 2, real, real)
    _, want = one_shot(model, params, toks)
    pad = SEGMENT_SHORT - real
    outs = [segment(model, params, toks, SEGMENT_SHORT,
                    fill=tokens_of(cfg, 2, pad, seed))
            for seed in (100, 101)]
    for logits, state in outs:
        for k in STATE:
            assert torch.equal(state[k], want[k]), k
    assert torch.equal(outs[0][0], outs[1][0])


@pytest.mark.parametrize("T", [CHUNK, 3 * CHUNK])
def test_wkv6_batched_passes_padded_chunks_through(T):
    """The recurrence over T real steps and then two chunks of k = 0,
    w = 1 ends in the state the real steps left, bit for bit."""
    g = torch.Generator().manual_seed(T)
    BH, dk, n = 3, 16, T + 2 * CHUNK
    r, k, v = (torch.randn((BH, n, dk), generator=g) for _ in range(3))
    w = torch.rand((BH, n, dk), generator=g) * 0.5 + 0.4
    k[:, T:] = 0.0
    w[:, T:] = 1.0
    u = torch.randn((BH, dk), generator=g)
    s0 = torch.randn((BH, dk, dk), generator=g)
    _, want = ops.wkv6_batched(r[:, :T], k[:, :T], v[:, :T], w[:, :T], u,
                               s0, chunk=CHUNK)
    _, got = ops.wkv6_batched(r, k, v, w, u, s0, chunk=CHUNK)
    assert torch.equal(got, want)


def test_an_unpadded_segment_equals_one_shot_bit_for_bit(smoke):
    """A segment whose positions are all real runs the one-shot
    prefill's numbers: the state bit for bit (the padding's selects keep
    every real value); the logits within 1e-5, the head's product
    reading its row from a gathered copy where the one-shot prefill
    reads a strided view."""
    cfg, model, params = smoke
    toks = tokens_of(cfg, 2, SEGMENT_SHORT, 7)
    want_logits, want = one_shot(model, params, toks)
    logits, state = segment(model, params, toks, SEGMENT_SHORT)
    for k in STATE:
        assert torch.equal(state[k], want[k]), k
    torch.testing.assert_close(logits, want_logits, **TOL)


def test_paths_without_a_count_never_pad(smoke, monkeypatch):
    """Training's forward, the S == 1 decode step and the one-shot
    prefill pass no count of real tokens, so none of them reaches the
    padding (``real_positions`` raising here): they run the ops they ran
    before segments existed."""
    cfg, model, params = smoke

    def refuse(*args, **kw):
        raise AssertionError("padding reached without a count")
    monkeypatch.setattr(rwkv6, "real_positions", refuse)
    toks = torch.from_numpy(tokens_of(cfg, 2, 40, 3)).long()
    loss, _ = model.loss(params, {"tokens": toks[:, :-1],
                                  "labels": toks[:, 1:]})
    assert torch.isfinite(loss)
    logits, state = one_shot(model, params, toks.int().numpy())
    with torch.inference_mode():
        step, _ = model.decode_step(params, state, toks[:, :1], 40)
    assert step.shape == logits.shape == (2, 1, cfg.vocab_size)


@pytest.mark.parametrize("S", [1, 255, 256, 257, 700, 1023, 1024, 1025,
                               1280, 1281, 2040, 2048, 2305])
def test_segments_cover_the_prompt(S):
    """The plan: long segments while more than a short one's tokens
    remain, then one short segment, each a whole number of wkv chunks,
    covering the prompt once, only the last padded: a short one where at
    most a short segment's tokens remained, else a long one."""
    plan = prefill_segments(S)
    assert SEGMENT_LONG % CHUNK == 0 and SEGMENT_SHORT % CHUNK == 0
    assert sum(n for _, n in plan) == S
    assert all((C, n) == (SEGMENT_LONG, SEGMENT_LONG) for C, n in plan[:-1])
    C, n = plan[-1]
    assert 0 < n <= C
    assert C == (SEGMENT_SHORT if n <= SEGMENT_SHORT else SEGMENT_LONG)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_segmented_prefill_is_rwkv6s_only(arch):
    """Only rwkv6, whose decode cache is an O(1) carried state, declares
    its prefill segmentable (a class attribute), and the generator
    segments only on the card."""
    model = build_model(get_smoke(arch))
    want = arch == "rwkv6-1.6b"
    assert getattr(model, "prefill_segmentable", False) is want
    assert ("prefill_segmentable" in vars(type(model))) is want
    gen = FusedGenerator(model)
    assert gen.segmented(torch.device("cuda", 0)) is want
    assert not gen.segmented(CPU)
    assert not gen.segmented(torch.device("meta"))


class _CountingModel:
    """Stands in for a model: counts the caches it allocates."""

    def __init__(self):
        self.made = []

    def init_cache(self, batch, max_len, *, device=None):
        self.made.append((batch, max_len))
        return {"k": torch.zeros(batch, max_len)}


def test_lane_keeps_segments_beside_decode_state(monkeypatch):
    """A lane keeps a segmented prefill's state per rows beside its
    decode state per (rows, capacity), under keys that never meet: each
    key returns its own kind, the same object on every ask; a lease for
    segments prefers the lane that keeps them; another params drops
    both."""
    monkeypatch.setattr(serve_executor, "_free_lanes", {})
    lane = serve_executor._Lane(CPU)
    model, params = _CountingModel(), object()
    dec = lane.state(model, params, (1, 1), CPU)
    seg = lane.segments(model, params, 1, CPU)
    assert type(dec) is serve_executor._Kept
    assert type(seg) is serve_executor._Segments
    assert lane.state(model, params, (1, 1), CPU) is dec
    assert lane.segments(model, params, 1, CPU) is seg
    assert lane.segments(model, params, 2, CPU) is not seg
    key = (serve_executor._Segments, 1)
    assert set(lane.kept) == {(1, 1), key, (serve_executor._Segments, 2)}
    assert lane.holds(model, params, key)
    assert not lane.holds(model, params, (1, 2))
    assert set(seg.tok) == {SEGMENT_LONG, SEGMENT_SHORT}
    assert seg.tok[SEGMENT_LONG].shape == (1, SEGMENT_LONG)
    assert seg.valid.dtype == torch.int32 and seg.valid.dim() == 0
    with serve_executor._lane(CPU, model, params, key) as a, \
            serve_executor._lane(CPU, model, params, key) as b:
        assert a is not b
    b.segments(model, params, 1, CPU)
    assert serve_executor._free_lanes[CPU] == [b, a]   # a freed last
    with serve_executor._lane(CPU, model, params, key) as got:
        assert got is b
    other = object()
    assert lane.segments(model, other, 1, CPU) is not seg
    assert list(lane.kept) == [key]


def test_segments_replay_kept_graphs_across_groups(smoke, seg_path):
    """Groups of 600, 200 and 1400 tokens, twice, on one thread: the
    first group's segment lengths capture once each on its lane (the
    segment run eagerly, then captured), every later segment replays;
    each group's tokens a generator's that does not segment; the
    captured launches added once a replay."""
    cfg, model, params = smoke
    plain = FusedGenerator(model)
    plain.segmented = lambda device: False
    gen = FusedGenerator(model)
    groups = [(tokens_of(cfg, 1, S, S), n)
              for S, n in ((600, 1), (200, 3), (1400, 2))]
    for p, n in groups * 2:
        np.testing.assert_array_equal(gen(params, p, n), plain(params, p, n))
    segments = 2 * sum(len(prefill_segments(p.shape[1])) for p, _ in groups)
    assert dispatch.events(PREFILL_CAPTURES) == 2
    assert dispatch.events(PREFILL_HITS) == segments - 2
    assert dispatch.launches("wkv6_batched") == (
        cfg.n_layers * (segments - 2))
    (lane,) = seg_path[CPU]
    (segs,) = lane.kept.values()
    assert set(segs.graphs) == {SEGMENT_LONG, SEGMENT_SHORT}


def test_decode_steps_run_from_the_segmented_state(smoke, seg_path,
                                                   monkeypatch):
    """After a segmented prefill the group decodes at int positions from
    the lane's carried state (no count of real tokens in it), to a
    one-shot generator's tokens; a second group starts from a zeroed
    state."""
    cfg, model, params = smoke
    plain = FusedGenerator(model)
    plain.segmented = lambda device: False
    step, seen = model.decode_step, []

    def spy(params, cache, tokens, pos):
        seen.append((pos, "valid" in cache))
        return step(params, cache, tokens, pos)
    gen = FusedGenerator(model)
    p, q = tokens_of(cfg, 3, 150, 1), tokens_of(cfg, 3, 140, 2)
    want = [plain(params, x, 5) for x in (p, q)]
    monkeypatch.setattr(model, "decode_step", spy)
    for x, w in zip((p, q), want):
        np.testing.assert_array_equal(gen(params, x, 5), w)
    assert seen == [(S + i, False) for S in (150, 140) for i in range(4)]


def test_segmented_prefill_spans(smoke, seg_path):
    """Under a chunk context a segmented prefill is one EV_PREFILL row of
    rows x S tokens, followed by an EV_GRAPH row "prefill-capture" and
    one "prefill-hit" where it had such segments, sized by them."""
    cfg, model, params = smoke
    gen = FusedGenerator(model)
    rec = trc.TraceRecorder()
    ctx = trc.ChunkContext(rec, time.monotonic(), 0)
    sizes = (700, 2100, 900)      # long; long, long, short; long
    for i, S in enumerate(sizes):
        ctx.run(i, i, gen, params, tokens_of(cfg, 1, S, i), 1)
    tr = rec.finalize()
    rows = [(int(k), tr.details.get(i), int(tr.size[i]))
            for i, k in enumerate(tr.kind)]
    assert rows == [(trc.EV_PREFILL, None, 700),
                    (trc.EV_GRAPH, "prefill-capture", 1),
                    (trc.EV_PREFILL, None, 2100),
                    (trc.EV_GRAPH, "prefill-capture", 1),
                    (trc.EV_GRAPH, "prefill-hit", 2),
                    (trc.EV_PREFILL, None, 900),
                    (trc.EV_GRAPH, "prefill-hit", 1)]


def test_a_duplicate_segments_on_another_lane(smoke, seg_path):
    """The same request served while its lane is leased goes to another
    lane, captures there, and gives the same tokens."""
    cfg, model, params = smoke
    gen = FusedGenerator(model)
    p = tokens_of(cfg, 1, 1300, 5)
    first = gen(params, p, 2)
    (lane,) = seg_path[CPU]
    key = (serve_executor._Segments, 1)
    with serve_executor._lane(CPU, model, params, key) as held:
        assert held is lane
        np.testing.assert_array_equal(gen(params, p, 2), first)
    assert len(seg_path[CPU]) == 2
    assert all(list(ln.kept) == [key] for ln in seg_path[CPU])
    assert dispatch.events(PREFILL_CAPTURES) == 2


def test_prefill_graph_share_reads_the_counters():
    """The benchmark's ``prefill_graph_share``: segments that replayed a
    kept graph over all segments in %; 0 where prefills ran and none in
    segments; None where no prefill ran."""
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "portbench"
            / "metrics" / "prefill_graph_share.py")
    spec = importlib.util.spec_from_file_location("prefill_graph_share",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    groups = {"groups": [dict(rows=1, S=300, n=1, wall_s=0.1,
                              prefill_s=0.1)]}
    dispatch.reset_launches()
    assert mod.compute({}) is None and mod.compute({"groups": []}) is None
    assert mod.compute(groups) == 0.0         # prefills, none segmented
    dispatch.count_event(serve_executor.GRAPH_HITS)
    assert mod.compute(groups) == 0.0
    for _ in range(19):
        dispatch.count_event(PREFILL_HITS)
    dispatch.count_event(PREFILL_CAPTURES)
    assert mod.compute(groups) == 95.0
    dispatch.reset_launches()
    assert mod.compute({}) is None


def test_chip_smoke_times_the_segmented_prefill(smoke, seg_path,
                                                monkeypatch):
    """``chip_smoke.time_segmented_prefill`` times the serving path's
    prefill where groups segment: its first call captures the prompt's
    one segment, the later ones replay it, each kind timed apart; where
    groups do not segment it times nothing."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg, model, params = smoke
    monkeypatch.setattr(chip_smoke, "PREFILL_T", 300)
    got = chip_smoke.time_segmented_prefill(model, params, reps=2)
    assert (got["captures"], got["hits"]) == (1, 2)
    assert len(got["capture_s"]) == 1 and len(got["replay_s"]) == 2
    monkeypatch.setattr(FusedGenerator, "segmented",
                        lambda self, device: False)
    assert chip_smoke.time_segmented_prefill(model, params) is None
