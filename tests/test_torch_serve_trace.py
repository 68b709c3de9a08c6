"""The serving executor's spans on the engine's flight recorder, on the
CPU: request-group, prefill and decode-step rows (``EV_GROUP``,
``EV_PREFILL``, ``EV_STEP``) inside a threaded traced ``serve`` with a
fail-stop, their nesting in the engine's chunks, the run's zero on the
Unix clock, the engine's own readings unchanged by them, and no span
where no chunk context is set (untraced, metrics-only, virtual-time and
process-mode runs).

Tolerance: none on counts, nesting and tokens; a span's thread CPU may
exceed its wall by the two clocks' read skew (``SLACK_S``).
"""

import json
import time

import numpy as np
import pytest

from repro_torch import api
from repro_torch.core import trace as trc
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.obs import MetricsHub
from repro_torch.runtime import RDLBServeExecutor, Request
from repro_torch.runtime.serve_executor import FusedGenerator

CFG = ModelConfig(family="dense", n_layers=2, d_model=64, n_heads=2,
                  n_kv_heads=2, d_ff=128, vocab_size=128, dtype="float32")
N = 16
P = 3
FAIL_AT = {1: 2}
#: seconds a span's thread CPU may read above its wall
SLACK_S = 2e-3
#: seconds of float rounding in the nesting of engine-time spans
EPS = 1e-9


@pytest.fixture(scope="module")
def smoke():
    model = build_model(CFG)
    return model, model.init(0, device="cpu")


def requests(seed=0):
    """Two prompt lengths and two token counts, so batched chunks hold
    groups of several rows and of one."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, CFG.vocab_size, size=int(S))
                    .astype(np.int32), max_new_tokens=int(n))
            for i, (S, n) in enumerate(zip(rng.choice([4, 6], N),
                                           rng.choice([2, 3], N)))]


def spec(mode="threaded", *, trace=True, metrics=False):
    s = api.serve_spec(technique="FAC", n_workers=P,
                       threaded=mode == "threaded")
    s = s.override("execution.trace", trace)
    s = s.override("execution.metrics", metrics)
    if mode == "process":
        s = (s.override("execution.mode", "process")
             .override("execution.stall_timeout", 120.0)
             .override("execution.wall_timeout", 300.0))
    return s


def serve(smoke, monkeypatch, run_spec, *, batch_decode=True,
          fused_decode=True, fail_at=FAIL_AT):
    """One ``serve`` -> (requests, EngineStats, the chunk contexts the
    generator saw)."""
    model, params = smoke
    kept = []
    run = api.run

    def keep(s, eng):
        kept.append(run(s, eng))
        return kept[-1]
    monkeypatch.setattr(api, "run", keep)
    ex = RDLBServeExecutor(model, params, spec=run_spec,
                           batch_decode=batch_decode,
                           fused_decode=fused_decode)
    seen = []
    if ex._fused is not None:
        fused = ex._fused

        def spy(*args):
            seen.append(trc.current())
            return fused(*args)
        ex._fused = spy
    reqs = requests()
    assert not ex.serve(reqs, fail_at=fail_at).hung
    return reqs, kept[-1], seen


def rows(tr, kind):
    return np.flatnonzero(tr.kind == kind)


def without_spans(tr):
    """The trace with the executor's rows taken out."""
    keep = np.flatnonzero(~np.isin(tr.kind, trc.SPAN_KINDS))
    cols = {c: getattr(tr, c)[keep] for c in trc._COLS}
    new = {int(old): i for i, old in enumerate(keep)}
    return trc.Trace(details={new[i]: d for i, d in tr.details.items()
                              if i in new}, meta=dict(tr.meta), **cols)


def expected_groups(reqs, tr, batch_decode):
    """seq -> rid lists of the groups each reported chunk decodes."""
    out = {}
    for i in rows(tr, trc.EV_EXEC):
        chunk = reqs[int(tr.start[i]):int(tr.start[i] + tr.size[i])]
        if batch_decode:
            by: dict = {}
            for r in chunk:
                by.setdefault((len(r.prompt), r.max_new_tokens),
                              []).append(r.rid)
            out[int(tr.seq[i])] = sorted(by.values())
        else:
            out[int(tr.seq[i])] = [[r.rid] for r in chunk]
    return out


MODES = [(False, True), (True, True), (True, False)]
MODE_IDS = ["per_request", "batched", "batched_per_token"]


@pytest.mark.parametrize("batch_decode,fused_decode", MODES, ids=MODE_IDS)
def test_one_group_span_per_executed_group(smoke, monkeypatch, batch_decode,
                                           fused_decode):
    """One EV_GROUP per group of every reported chunk, with its real
    rows, first rid and rid list, inside that chunk's EV_EXEC."""
    reqs, st, _ = serve(smoke, monkeypatch, spec(),
                        batch_decode=batch_decode, fused_decode=fused_decode)
    tr = st.trace
    want = expected_groups(reqs, tr, batch_decode)
    got: dict = {}
    for i in rows(tr, trc.EV_GROUP):
        rids = tr.group_rids(i)
        assert int(tr.start[i]) == rids[0] and int(tr.size[i]) == len(rids)
        assert (int(i) in tr.details) == (len(rids) > 1)
        got.setdefault(int(tr.seq[i]), []).append(rids)
        ex = [j for j in rows(tr, trc.EV_EXEC)
              if tr.seq[j] == tr.seq[i] and tr.wid[j] == tr.wid[i]]
        assert len(ex) == 1
        j = ex[0]
        assert tr.t[j] - EPS <= tr.t[i]
        assert tr.t[i] + tr.dt[i] <= tr.t[j] + tr.dt[j] + EPS
    assert {k: sorted(v) for k, v in got.items()} == want
    if not fused_decode:
        assert not len(rows(tr, trc.EV_PREFILL)) + len(rows(tr, trc.EV_STEP))


@pytest.mark.parametrize("batch_decode", [False, True],
                         ids=["per_request", "batched"])
def test_prefill_and_steps_nest_in_their_group(smoke, monkeypatch,
                                               batch_decode):
    """A prefill and max_new - 1 steps a group, each inside the group of
    its wid, seq and first rid; tokens as an untraced run's."""
    reqs, st, _ = serve(smoke, monkeypatch, spec(),
                        batch_decode=batch_decode)
    tr = st.trace
    groups = rows(tr, trc.EV_GROUP)
    key = {(int(tr.wid[g]), int(tr.seq[g]), int(tr.start[g])): g
           for g in groups}
    assert len(key) == len(groups)
    inside = {g: [] for g in groups}
    for k in (trc.EV_PREFILL, trc.EV_STEP):
        for i in rows(tr, k):
            g = key[(int(tr.wid[i]), int(tr.seq[i]), int(tr.start[i]))]
            assert tr.t[g] - EPS <= tr.t[i]
            assert tr.t[i] + tr.dt[i] <= tr.t[g] + tr.dt[g] + EPS
            inside[g].append(int(k))
    n_new = {r.rid: r.max_new_tokens for r in reqs}
    for g, kinds in inside.items():
        assert kinds.count(trc.EV_PREFILL) == 1
        assert kinds.count(trc.EV_STEP) == n_new[int(tr.start[g])] - 1
    assert len(rows(tr, trc.EV_STEP)) == sum(
        n_new[int(tr.start[g])] - 1 for g in groups)
    # the padded rows: a prefill's size is rows x S, a step's rows
    for i in rows(tr, trc.EV_STEP):
        g = key[(int(tr.wid[i]), int(tr.seq[i]), int(tr.start[i]))]
        assert tr.size[i] >= tr.size[g]
        assert tr.size[i] & (tr.size[i] - 1) == 0
    plain = requests()
    RDLBServeExecutor(*smoke, spec=spec(trace=False),
                      batch_decode=batch_decode).serve(plain,
                                                       fail_at=FAIL_AT)
    for a, b in zip(reqs, plain):
        np.testing.assert_array_equal(a.output, b.output)


def test_thread_cpu_within_wall_and_the_unix_zero(smoke, monkeypatch):
    before = time.time_ns()
    _, st, seen = serve(smoke, monkeypatch, spec())
    after = time.time_ns()
    tr = st.trace
    assert before <= tr.meta["t0_unix_ns"] <= after
    m = np.isin(tr.kind, trc.SPAN_KINDS)
    assert m.any() and (tr.aux[m] >= 0).all()
    assert (tr.aux[m] / 1e6 <= tr.dt[m] + SLACK_S).all()
    assert all(c is not None for c in seen)
    spans = tr.unix_spans()
    assert len(spans) == int(m.sum())
    assert all(before <= a <= b <= after for a, b, _ in spans)
    assert trc.current() is None          # cleared on the engine's threads
    back = trc.Trace.from_dict(json.loads(json.dumps(tr.to_dict())))
    assert back.meta["t0_unix_ns"] == tr.meta["t0_unix_ns"]
    assert back.unix_spans() == spans


def test_engine_readings_unchanged_by_the_spans(smoke, monkeypatch):
    """counters, utilization, dispatch latency and a MetricsHub fed the
    rows read the same with the executor's rows taken out; the live hub
    of a traced and metered run counted no span."""
    _, st, _ = serve(smoke, monkeypatch, spec(metrics=True))
    tr = st.trace
    bare = without_spans(tr)
    assert len(bare) < len(tr)
    assert tr.counters() == bare.counters()
    assert tr.utilization(50) == bare.utilization(50)
    assert tr.dispatch_latency() == bare.dispatch_latency()
    assert tr.overhead_decomposition() == bare.overhead_decomposition()
    hubs = []
    for t in (tr, bare):
        hub = MetricsHub(n_workers=P)
        for i in range(len(t)):
            hub.observe(int(t.kind[i]), float(t.t[i]), int(t.wid[i]),
                        int(t.seq[i]), int(t.start[i]), int(t.size[i]),
                        int(t.aux[i]), float(t.dt[i]))
        hubs.append(hub.snapshot())
    assert hubs[0] == hubs[1]
    assert st.metrics["n_events"] == len(bare)


@pytest.mark.parametrize("mode", ["untraced", "metrics_only", "virtual",
                                  "process"])
def test_no_spans_without_a_chunk_context(smoke, monkeypatch, mode):
    run_spec = {"untraced": spec(trace=False),
                "metrics_only": spec(trace=False, metrics=True),
                "virtual": spec("virtual"),
                "process": spec("process")}[mode]
    _, st, seen = serve(smoke, monkeypatch, run_spec,
                        fail_at=None if mode == "process" else FAIL_AT)
    assert all(c is None for c in seen)
    if mode in ("untraced", "metrics_only"):
        assert st.trace is None
    else:
        assert len(st.trace) and not np.isin(st.trace.kind,
                                             trc.SPAN_KINDS).any()
        assert "t0_unix_ns" not in st.trace.meta


class _NoPrefill:
    """The smoke model without ``prefill``: the generator walks the
    prompt through ``decode_step``."""

    def __init__(self, model):
        self.init_cache = model.init_cache
        self.decode_step = model.decode_step


@pytest.mark.parametrize("walk", [False, True], ids=["prefill", "walk"])
def test_generator_spans_under_a_context(smoke, walk):
    """Under a context: one prefill span (prompt walk included) of
    padded rows x S, max_new - 1 steps of padded rows, the context's seq
    and rid, and the tokens of a call without one."""
    model, params = smoke
    gen = FusedGenerator(_NoPrefill(model) if walk else model)
    prompts = np.stack([requests()[i].prompt[:4] for i in range(3)])
    plain = gen(params, prompts, 5)
    rec = trc.TraceRecorder()
    ctx = trc.ChunkContext(rec, time.monotonic(), 0)
    np.testing.assert_array_equal(ctx.run(7, 3, gen, params, prompts, 5),
                                  plain)
    assert trc.current() is None
    tr = rec.finalize()
    assert tr.kind.tolist() == [trc.EV_PREFILL] + [trc.EV_STEP] * 4
    assert tr.size.tolist() == [4 * 4] + [4] * 4
    assert set(tr.seq.tolist()) == {7} and set(tr.start.tolist()) == {3}
    # steps follow back to back
    np.testing.assert_allclose(tr.t[2:], (tr.t + tr.dt)[1:-1], atol=1e-3)


def test_chrome_export_draws_the_spans(smoke, monkeypatch, tmp_path):
    """The three spans are nested slices in their replica's lane
    (category ``model``, args rid, rows, CPU µs); the file carries the
    Unix zero and loads back whole."""
    _, st, _ = serve(smoke, monkeypatch, spec())
    tr = st.trace
    doc = trc.to_chrome(tr)
    assert doc["otherData"]["t0_unix_ns"] == tr.meta["t0_unix_ns"]
    model = [e for e in doc["traceEvents"] if e.get("cat") == "model"]
    assert len(model) == int(np.isin(tr.kind, trc.SPAN_KINDS).sum())
    execs = [e for e in doc["traceEvents"] if e.get("cat") == "exec"]
    for e in model:
        assert e["ph"] == "X"
        assert {"rid", "rows", "cpu_us", "seq"} <= set(e["args"])
        assert any(x["tid"] == e["tid"] and x["args"]["seq"]
                   == e["args"]["seq"] and x["ts"] - 1e-3 <= e["ts"]
                   and e["ts"] + e["dur"] <= x["ts"] + x["dur"] + 1e-3
                   for x in execs)
    names = {e["name"].split()[0] for e in model}
    assert names == {"group", "prefill", "step"}
    path = tmp_path / "serve.trace.json"
    trc.save_chrome(tr, path)
    back = trc.load_trace(path)
    assert back.meta["t0_unix_ns"] == tr.meta["t0_unix_ns"]
    assert back.executor_spans() == tr.executor_spans()
