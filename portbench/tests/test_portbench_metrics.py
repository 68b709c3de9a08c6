"""Each metric module on a hand-made record, against the value worked
out by hand; a metric with nothing to read gives None."""

import math

import pytest

from portbench import harness
from portbench.counts import flash_attention, flash_decode, olmo, peaks
from portbench.counts import rwkv6, wkv6_batched, wkv6_decode
from portbench.tests.conftest import benchmark

OLMO = dict(n_layers=2, d_model=8, n_heads=2, n_kv_heads=2, d_ff=16,
            vocab_size=10)
RWKV = dict(n_layers=2, d_model=8, d_ff=16, vocab_size=10, rwkv_head_dim=4,
            lora_rank=2)


def record(**kw):
    rec = dict(
        model=OLMO, window_s=10.0, setup_s=12.5, flops=olmo,
        commits=[dict(S=3, n=2, since_loop_s=t)
                 for t in (1.0, 2.0, 3.0, 4.0, 9.0, 9.9)],
        loops=[dict(n_requests=4, n_committed=4, n_duplicates=1,
                    hung=False, span_s=5.0, worker_busy=(0.5, 4.0)),
               dict(n_requests=4, n_committed=2, n_duplicates=2,
                    hung=False, span_s=5.0, worker_busy=(1.0, 2.0))],
        groups=[dict(rows=1, S=3, n=3, wall_s=0.5, prefill_s=0.1),
                dict(rows=2, S=4, n=1, wall_s=0.2, prefill_s=0.2),
                dict(rows=3, S=5, n=5, wall_s=1.0, prefill_s=0.2)],
        trace=dict(kernel_s={"flash_decode": 2e-6, "flash_attention": 4e-6},
                   busy_s=0.25, span_s=1.0, device_ops=[], idle_gaps=[],
                   groups=[dict(rows=1, S=3, n=3), dict(rows=2, S=4, n=1)]))
    rec.update(kw)
    return rec


def metric(name):
    return harness.load_module("metrics", name).compute


def test_every_metric_has_a_module():
    bench = benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(metric(m["name"]))


def test_end_to_end():
    rec = record()
    assert metric("tasks_per_s")(rec) == 6 / 10.0
    # numpy's linear 95th percentile of 1, 2, 3, 4, 9, 9.9: 9 + 0.75 * 0.9
    assert metric("task_p95_s")(rec) == pytest.approx(9.675)
    assert metric("setup_s")(rec) == 12.5


def test_engine_and_executor():
    rec = record()
    assert metric("dup_share")(rec) == pytest.approx(100 * 3 / 6)
    assert metric("worker_busy_share")(rec) == pytest.approx(
        100 * (0.5 * 4 + 1.0 * 2) / 6)
    # groups that decode: (0.5 - 0.1) / 2 steps and (1.0 - 0.2) / 4
    assert metric("decode_step_ms")(rec) == pytest.approx(1e3 * 1.2 / 6)
    assert metric("group_rows")(rec) == pytest.approx(2.0)


def test_mfu_counts_committed_in_window():
    rec = record()
    want = 6 * olmo.request_flops(OLMO, 3, 2) / (10.0 * peaks.PEAK_BF16)
    assert metric("mfu")(rec) == pytest.approx(100 * want)


def test_olmo_flops_by_hand():
    d, L, V, ff, D, H = 8, 2, 10, 16, 4, 2
    per_tok = 2 * L * (4 * d * d + 3 * d * ff)
    want = (3 * per_tok + L * H * 4 * D * 6 + 2 * d * V       # prefill
            + per_tok + L * H * 4 * D * 4 + 2 * d * V)        # one step
    assert olmo.request_flops(OLMO, 3, 2) == want


def test_rwkv6_flops_by_hand():
    d, ff, L, r, V, dh = 8, 16, 2, 2, 10, 4
    per_tok = L * (2 * (5 * d * d + 10 * d * r + 2 * d * ff + d * d)
                   + 7 * d * dh)
    assert rwkv6.request_flops(RWKV, 5, 3) == 7 * per_tok + 3 * 2 * d * V


def test_rooflines():
    rec = record()
    fd = flash_decode.group_bound_s(OLMO, dict(rows=1, S=3, n=3))
    assert metric("flash_decode_roofline")(rec) == pytest.approx(
        100 * fd / 2e-6)
    fa = sum(flash_attention.group_bound_s(OLMO, g)
             for g in rec["trace"]["groups"])
    assert metric("flash_attention_roofline")(rec) == pytest.approx(
        100 * fa / 4e-6)
    assert metric("device_idle_share")(rec) == pytest.approx(75.0)
    rrec = record(model=RWKV, trace=dict(
        kernel_s={"wkv6_decode": 1e-6, "wkv6_batched": 3e-6}, busy_s=0.5,
        span_s=1.0, groups=[dict(rows=1, S=40, n=3)]))
    wd = wkv6_decode.group_bound_s(RWKV, dict(rows=1, S=40, n=3))
    wb = wkv6_batched.group_bound_s(RWKV, dict(rows=1, S=40, n=3))
    assert metric("wkv6_decode_roofline")(rrec) == pytest.approx(
        100 * wd / 1e-6)
    assert metric("wkv6_batched_roofline")(rrec) == pytest.approx(
        100 * wb / 3e-6)


def test_nothing_to_read_gives_none():
    empty = record(commits=[], loops=[], groups=[], trace=None)
    for m in ("tasks_per_s", "task_p95_s", "dup_share", "worker_busy_share",
              "decode_step_ms", "group_rows", "mfu", "flash_decode_roofline",
              "flash_attention_roofline", "wkv6_decode_roofline",
              "wkv6_batched_roofline", "device_idle_share"):
        assert metric(m)(empty) is None, m
    # a kernel the trace did not see
    assert metric("wkv6_decode_roofline")(record()) is None


def test_profile_summary():
    """Union of device intervals, kernel seconds by site, gaps charged
    to the innermost host span open at their middle."""
    from portbench import profiling
    dev = [(0, 10, "void flash_decode_kernel<x>"),
           (5, 20, "gemm"),
           (30, 40, "flash_attention_wgmma_kernel"),
           (45, 50, "gemm"),
           (70, 80, "gemm")]
    spans = [(0, 100, "chunk"), (21, 29, "decode_step"),
             (40, 48, "prefill"), (41, 49, "decode_step")]
    s = profiling.summarize(dev, spans, ["flash_decode", "flash_attention"])
    assert s["busy_s"] == pytest.approx(45e-9)
    assert s["kernel_s"] == pytest.approx(
        {"flash_decode": 10e-9, "flash_attention": 10e-9})
    labels = dict(profiling.LABELS)
    assert dict(s["idle_gaps"]) == pytest.approx({
        labels["decode_step"]: 15e-9, labels["chunk"]: 20e-9})
    assert s["device_ops"][0] == ["gemm", pytest.approx(30e-9)]
    s = profiling.summarize(dev[:2] + [(90, 95, "gemm")], [], ["x"])
    assert s["idle_gaps"] == [[profiling.OUTSIDE, pytest.approx(70e-9)]]
    assert math.isclose(profiling.summarize([], [], ["x"])["busy_s"], 0.0)


class _Loops:
    """Stands in for ``harness.Runner``: each loop lasts ``span`` s of
    a clock it keeps itself."""

    trace = False

    def __init__(self, span):
        self.span, self.now, self.started = span, 100.0, []

    def clock(self):
        return self.now

    def loop(self, index, profile=False):
        self.started.append(index)
        self.now += self.span
        return dict(index=index)


def test_window_ends_with_its_last_whole_loop(monkeypatch):
    """Loops start while fewer than ``seconds`` have passed, and the
    window closes when the last one ends, not at ``seconds``."""
    runner = _Loops(0.04)
    monkeypatch.setattr(harness.time, "perf_counter", runner.clock)
    loops, t0, t1 = harness.window(runner, 0.1)
    assert runner.started == [1, 2, 3] and len(loops) == 3
    assert t1 - t0 == pytest.approx(3 * 0.04)


def test_sites_checked_by_the_phases_the_window_ran():
    """A config's decode sites are due only when some group decoded."""
    from repro_torch.kernels import dispatch

    class Cell:
        config = dict(sites={"flash_attention": "prefill",
                             "flash_decode": "decode"})
    dispatch.reset_launches()
    scoring = [dict(groups=[dict(rows=1, S=9, n=1)])]
    decoding = [dict(groups=[dict(rows=1, S=9, n=1),
                             dict(rows=1, S=9, n=4)])]
    assert harness.sites_check(Cell, scoring)["sites"] == ["flash_attention"]
    assert harness.sites_check(Cell, decoding)["sites"] == [
        "flash_attention", "flash_decode"]
