"""The port's telemetry (repro_torch.obs) against the reference's
(repro.obs): the streaming estimators on one stream, the MetricsHub that
``api.build`` hangs on a run, ``run_telemetry`` and ``calibrate_trace``
on one saved trace, and the CLI's ``trace calibrate`` and ``--emit-json``.

Tolerance: none.  The copy runs the same float64 host arithmetic on the
same events, so every record must be identical.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from repro import api as japi
from repro import obs as jobs
from repro.api import cli as jcli
from repro.core import simulator as jsim
from repro.core import trace as jtrace
from repro_torch import api, obs
from repro_torch.api import cli
from repro_torch.core import simulator, trace


def _spec(mod, P, mode, *, workers=(), technique="FAC", trace=True,
          metrics=True):
    return mod.RunSpec(
        scheduling=mod.SchedulingSpec(technique=technique),
        cluster=mod.ClusterSpec(n_workers=P, workers=workers,
                                name=f"obs_{mode}"),
        execution=mod.ExecutionSpec(
            mode=mode, h=1e-4 if mode == "virtual" else 0.0,
            stall_timeout=10.0, wall_timeout=60.0,
            trace=trace, metrics=metrics))


def _task_times(N, seed=2):
    return np.abs(np.random.default_rng(seed).normal(0.002, 5e-4, N)) + 1e-4


def test_estimators_equal_reference():
    xs = np.random.default_rng(1).lognormal(0.0, 0.5, 2000)
    pairs = [(obs.Welford(), jobs.Welford()), (obs.EWMA(0.3), jobs.EWMA(0.3))]
    pairs += [(obs.P2Quantile(p), jobs.P2Quantile(p))
              for p in (0.5, 0.9, 0.99)]
    for x in xs:
        for a, b in pairs:
            a.add(float(x))
            b.add(float(x))
    w, jw = pairs[0]
    assert (w.n, w.mean, w.std) == (jw.n, jw.mean, jw.std)
    assert pairs[1][0].value == pairs[1][1].value
    for a, b in pairs[2:]:
        assert a.value() == b.value()


@pytest.mark.parametrize("trace_on", [True, False],
                         ids=["trace", "metrics_only"])
def test_build_hangs_metrics_hub_like_reference(trace_on):
    """``execution.metrics`` in ``api.build``: the hub's snapshot of a
    virtual run under a fail-stop equals the reference's; metrics
    without trace keep no rows."""
    P, N = 4, 200
    tt = _task_times(N)
    workers = ((japi.WorkerSpec(),) * (P - 1)
               + (japi.WorkerSpec(fail_time=0.06),))
    jspec = _spec(japi, P, "virtual", workers=workers, trace=trace_on)
    spec = api.RunSpec.from_dict(jspec.to_dict())
    st = api.run(spec, api.build(spec, simulator.SimBackend(tt), n_tasks=N))
    jst = japi.run(jspec, japi.build(jspec, jsim.SimBackend(tt), n_tasks=N))
    assert st.metrics == jst.metrics
    assert st.metrics["deaths"] == 1 and st.metrics["finished"] == N
    assert (st.trace is None) == (not trace_on)
    json.dumps(st.metrics)


def _saved_traces(tmp_path, jspec, tt):
    """One reference run's trace, saved once and loaded by each package."""
    r = japi.simulate(jspec, tt)
    path = tmp_path / "run.trace.json"
    jtrace.save_chrome(r.trace, path)
    return trace.load_trace(str(path)), jtrace.load_trace(str(path))


@pytest.mark.parametrize("mode", ["virtual", "threaded"])
def test_telemetry_and_calibration_equal_reference(tmp_path, mode):
    """The same trace gives the same ``run_telemetry`` record and the same
    calibrated spec (speeds, h, latencies, residuals) as the reference —
    a virtual run with a straggler, and a threaded run whose tasks sleep
    (wall-clock dispatch latencies, so h is fitted too)."""
    P, N = 4, 160
    tt = _task_times(N, seed=3)
    if mode == "virtual":
        workers = tuple(japi.WorkerSpec(speed=0.5 if w == 2 else 1.0)
                        for w in range(P))
    else:
        workers = tuple(japi.WorkerSpec(sleep_per_task=0.003)
                        for _ in range(P))
    jspec = _spec(japi, P, mode, workers=workers, metrics=False)
    spec = api.RunSpec.from_dict(jspec.to_dict())
    tr, jtr = _saved_traces(tmp_path, jspec, tt)
    assert obs.run_telemetry(tr) == jobs.run_telemetry(jtr)
    for times in (tt, None):
        got = obs.calibrate_trace(tr, spec, task_times=times)
        want = jobs.calibrate_trace(jtr, jspec, task_times=times)
        assert got.spec.to_dict() == want.spec.to_dict()
        assert got.to_dict() == want.to_dict()
        assert got.summary() == want.summary()


def test_spec_calibrator_equals_reference():
    """The in-loop calibrator's drift detector on one measurement stream."""
    import dataclasses as dc

    class St:
        def __init__(self, rate):
            self.n_samples, self.compute_time = 10, 1.0
            self._r = rate

        def rate(self, include_overhead):
            return self._r

    @dc.dataclass
    class W:
        wid: int
        alive: bool
        speed: float
        stats: object

    @dc.dataclass
    class Snap:
        workers: list

    tt = np.full(10, 0.01)
    a = obs.SpecCalibrator(task_times=tt, threshold=0.2, alpha=0.7)
    b = jobs.SpecCalibrator(task_times=tt, threshold=0.2, alpha=0.7)
    for rates in ((100.0, 90.0), (105.0, 92.0), (50.0, 91.0), (52.0, 40.0)):
        snap = Snap([W(i, True, 1.0, St(r)) for i, r in enumerate(rates)])
        sa, ia = a.apply(snap)
        sb, ib = b.apply(snap)
        assert ia == ib
        assert [w.speed for w in sa.workers] == [w.speed for w in sb.workers]
    assert a.n_calibrations == b.n_calibrations


def test_cli_trace_calibrate_and_emit_json(tmp_path):
    """``run --trace``, ``run --emit-json`` of a traced run and ``trace
    calibrate`` through the port's CLI; the calibrated spec equals the
    reference CLI's on the same trace file."""
    doc = {
        "workload": {"kind": "uniform", "n": 96, "t": 0.004},
        "spec": _spec(api, 3, "virtual", trace=True, metrics=False)
        .replace(cluster=api.ClusterSpec(
            3, tuple(api.WorkerSpec(speed=s) for s in (1.0, 0.5, 1.0)),
            name="cli_cal")).to_dict(),
    }
    sf = tmp_path / "run.json"
    sf.write_text(json.dumps(doc))
    tr, rec = tmp_path / "out.json", tmp_path / "rec.json"
    assert cli.main(["run", "--spec", str(sf), "--trace", str(tr),
                     "--emit-json", str(rec), "--device", "cpu"]) == 0
    record = json.loads(rec.read_text())
    assert record["telemetry"] == obs.run_telemetry(
        trace.load_trace(str(tr)))
    cal, jcal = tmp_path / "cal.json", tmp_path / "jcal.json"
    assert cli.main(["trace", "calibrate", str(tr), "--spec", str(sf),
                     "-o", str(cal), "--device", "cpu"]) == 0
    assert jcli.main(["trace", "calibrate", str(tr), "--spec", str(sf),
                      "-o", str(jcal)]) == 0
    assert json.loads(cal.read_text()) == json.loads(jcal.read_text())
    speeds = [w.speed for w in
              api.RunSpec.load(cal).cluster.worker_specs()]
    assert speeds == pytest.approx([1.0, 0.5, 1.0], rel=1e-6)
    assert cli.main(["trace", "calibrate", str(tr)]) == 2   # no --spec


def test_cli_trace_summarize_prints_executor_spans(tmp_path, capsys):
    """``trace summarize`` through the port's CLI: on a reference trace
    (no executor spans) the reference's digest; with a serving chunk's
    group, prefill and step rows added, the same engine lines and one
    line a span kind with its count and mean wall."""
    jspec = _spec(japi, 3, "virtual", metrics=False)
    tr, jtr = _saved_traces(tmp_path, jspec, _task_times(60))
    assert cli.main(["trace", "summarize",
                     str(tmp_path / "run.trace.json")]) == 0
    assert capsys.readouterr().out.strip() == jtrace.summarize(jtr)
    rows = [tuple(getattr(tr, c)[i].item() for c in trace._COLS)
            for i in range(len(tr))]
    rows += [(trace.EV_GROUP, 0.01, 0, 1, 4, 2, 30000, 0.04, "[4, 5]"),
             (trace.EV_PREFILL, 0.011, 0, 1, 4, 2 * 6, 9000, 0.01),
             (trace.EV_STEP, 0.021, 0, 1, 4, 2, 5000, 0.012),
             (trace.EV_STEP, 0.033, 0, 1, 4, 2, 5000, 0.014)]
    rec = trace.TraceRecorder(meta=dict(tr.meta, t0_unix_ns=10 ** 18))
    rec.merge_raw(rows)
    path = tmp_path / "spans.trace.json"
    trace.save_chrome(rec.finalize(), path)
    assert cli.main(["trace", "summarize", str(path)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    want = jtrace.summarize(jtr).splitlines()
    assert out[1:len(want)] == want[1:]
    assert out[len(want):] == [
        "span group: n=1 mean_wall=0.040000s cpu/wall=0.750",
        "span prefill: n=1 mean_wall=0.010000s cpu/wall=0.900",
        "span step: n=2 mean_wall=0.013000s cpu/wall=0.385"]
    back = trace.load_trace(path)
    assert back.group_rids(int(np.flatnonzero(
        back.kind == trace.EV_GROUP)[0])) == [4, 5]
    assert back.unix_spans()[0] == (10 ** 18 + 10 ** 7,
                                    10 ** 18 + 5 * 10 ** 7, "group")
