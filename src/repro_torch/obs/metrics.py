"""Online estimators over the flight-recorder event stream.

Everything here is *streaming*: one ``observe()`` per event, O(1) state,
no event retention — so a :class:`MetricsHub` can ride along a
million-event run (or a metrics-only run that never stores rows at all,
``ExecutionSpec.metrics=True`` with ``trace=False``) and still answer
the questions the calibration layer needs:

  * per-worker effective speed (tasks/s and seconds-per-task, Welford
    mean/variance over executed chunks);
  * dispatch overhead ``h`` (P² p50 sketch over assign/re-issue
    latencies) and the request-latency distribution (p50/p99/mean/max);
  * utilization (busy worker-seconds over the observed span);
  * duplicate and waste rates (EWMA over dispatches / reports).

The hub is fed by :class:`repro_torch.core.trace.TraceRecorder` — every
engine that can trace can meter, in all four execution modes, with the
same zero-cost-when-off contract (``hub=None`` → no call sites touched).

Estimator notes: the quantile sketch is the P² algorithm of Jain &
Chlamtac (CACM 1985) — five markers per tracked quantile, parabolic
interpolation — chosen because dispatch latencies arrive one at a time
from handler threads and the exact ``np.percentile`` path
(``Trace.dispatch_latency``) needs the full stored trace.
"""

from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.trace import (
    EV_ASSIGN, EV_DEATH, EV_EXEC, EV_FF_SPAN, EV_GROUP, EV_REISSUE,
    EV_REPORT,
)

__all__ = ["Welford", "P2Quantile", "EWMA", "MetricsHub", "run_telemetry"]


class Welford:
    """Streaming mean/variance (Welford's algorithm)."""

    __slots__ = ("n", "mean", "_m2")

    def __init__(self) -> None:
        self.n = 0
        self.mean = 0.0
        self._m2 = 0.0

    def add(self, x: float) -> None:
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self._m2 += d * (x - self.mean)

    @property
    def var(self) -> float:
        return self._m2 / (self.n - 1) if self.n > 1 else 0.0

    @property
    def std(self) -> float:
        return math.sqrt(self.var)

    def to_dict(self) -> dict:
        return dict(n=self.n, mean=self.mean, std=self.std)


class P2Quantile:
    """Single-quantile P² sketch (Jain & Chlamtac 1985).

    Five markers track (min, p/2, p, (1+p)/2, max); marker heights move
    by piecewise-parabolic interpolation.  Exact for the first five
    observations, O(1) per observation after.
    """

    __slots__ = ("p", "n", "_q", "_pos", "_dn")

    def __init__(self, p: float) -> None:
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {p}")
        self.p = p
        self.n = 0
        self._q: list = []                     # marker heights
        self._pos = [0.0, 1.0, 2.0, 3.0, 4.0]  # marker positions
        self._dn = [0.0, p / 2, p, (1 + p) / 2, 1.0]

    def add(self, x: float) -> None:
        # hot path: one call per dispatch event, under the recorder lock
        n = self.n = self.n + 1
        q = self._q
        if n <= 5:
            q.append(x)
            if n == 5:
                q.sort()
            return
        # locate the cell (chained compares beat a search loop),
        # stretching the extremes if needed; `lo` is the first marker
        # position shifted right by this observation
        if x < q[1]:
            if x < q[0]:
                q[0] = x
            lo = 1
        elif x < q[2]:
            lo = 2
        elif x < q[3]:
            lo = 3
        else:
            if x >= q[4]:
                q[4] = x
            lo = 4
        pos = self._pos
        for i in range(lo, 5):
            pos[i] += 1.0
        # desired position of marker i after n observations is exactly
        # (n - 1) * dn[i] (0-based positions), so no accumulator list
        dn = self._dn
        m = float(n - 1)
        for i in (1, 2, 3):
            d = m * dn[i] - pos[i]
            if ((d >= 1.0 and pos[i + 1] - pos[i] > 1.0)
                    or (d <= -1.0 and pos[i - 1] - pos[i] < -1.0)):
                s = 1.0 if d > 0 else -1.0
                qp = self._parabolic(i, s)
                if not (q[i - 1] < qp < q[i + 1]):
                    qp = self._linear(i, s)
                q[i] = qp
                pos[i] += s

    def _parabolic(self, i: int, s: float) -> float:
        q, n = self._q, self._pos
        return q[i] + s / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + s) * (q[i + 1] - q[i])
            / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - s) * (q[i] - q[i - 1])
            / (n[i] - n[i - 1]))

    def _linear(self, i: int, s: float) -> float:
        q, n = self._q, self._pos
        j = i + int(s)
        return q[i] + s * (q[j] - q[i]) / (n[j] - n[i])

    def value(self) -> float:
        """Current quantile estimate (exact while n <= 5)."""
        if self.n == 0:
            return 0.0
        if self.n < 5:
            srt = sorted(self._q)
            # nearest-rank interpolation over the few exact samples
            idx = self.p * (len(srt) - 1)
            lo = int(math.floor(idx))
            hi = min(lo + 1, len(srt) - 1)
            return srt[lo] + (idx - lo) * (srt[hi] - srt[lo])
        return self._q[2]


class EWMA:
    """Exponentially-weighted moving average; ``value`` is None until
    the first observation."""

    __slots__ = ("alpha", "value")

    def __init__(self, alpha: float = 0.05) -> None:
        self.alpha = alpha
        self.value: Optional[float] = None

    def add(self, x: float) -> float:
        self.value = (x if self.value is None
                      else self.alpha * x + (1.0 - self.alpha) * self.value)
        return self.value


class _WorkerMeter:
    """Per-worker accumulator: executed tasks, busy seconds, streaming
    seconds-per-task."""

    __slots__ = ("tasks", "chunks", "busy", "per_task", "alive")

    def __init__(self) -> None:
        self.tasks = 0
        self.chunks = 0
        self.busy = 0.0
        self.per_task = Welford()
        self.alive = True

    def to_dict(self) -> dict:
        sec = self.per_task.mean
        return dict(tasks=self.tasks, chunks=self.chunks,
                    busy_s=self.busy, alive=self.alive,
                    sec_per_task=sec,
                    sec_per_task_std=self.per_task.std,
                    rate=(self.tasks / self.busy if self.busy > 0 else 0.0))


class MetricsHub:
    """Streaming run telemetry, fed one event at a time by the recorder.

    ``observe()`` mirrors ``TraceRecorder.event()``'s row fields and is
    invoked under the recorder's lock, so no additional synchronization
    is needed on the write path.  ``snapshot()`` is called after the run
    (or from the engine's thread between events) and returns a plain
    JSON-safe dict.
    """

    __slots__ = ("n_workers", "n_events", "dispatch", "disp_p50",
                 "disp_p99", "n_dispatches", "n_duplicates", "dup_rate",
                 "finished", "reported_tasks", "wasted_tasks",
                 "waste_rate", "deaths", "busy_s", "_t_lo", "_t_hi",
                 "workers")

    def __init__(self, n_workers: int = 0) -> None:
        self.n_workers = int(n_workers)
        self.n_events = 0
        self.dispatch = Welford()
        self.disp_p50 = P2Quantile(0.50)
        self.disp_p99 = P2Quantile(0.99)
        self.n_dispatches = 0
        self.n_duplicates = 0
        self.dup_rate = EWMA(alpha=0.05)
        self.finished = 0
        self.reported_tasks = 0
        self.wasted_tasks = 0
        self.waste_rate = EWMA(alpha=0.05)
        self.deaths = 0
        self.busy_s = 0.0
        self._t_lo = math.inf
        self._t_hi = -math.inf
        self.workers: dict[int, _WorkerMeter] = {}

    def _meter(self, wid: int) -> _WorkerMeter:
        m = self.workers.get(wid)
        if m is None:
            m = self.workers[wid] = _WorkerMeter()
        return m

    # ------------------------------------------------------------ ingest
    def observe(self, kind: int, t: float, wid: int, seq: int,
                start: int, size: int, aux: int, dt: float) -> None:
        if kind >= EV_GROUP:
            return              # the executor's spans: not engine events
        self.n_events += 1
        if t < self._t_lo:
            self._t_lo = t
        if t > self._t_hi:
            self._t_hi = t
        if kind == EV_EXEC:
            m = self._meter(wid)
            m.chunks += 1
            m.tasks += size
            m.busy += dt
            if size > 0:
                m.per_task.add(dt / size)
            self.busy_s += dt
            if t + dt > self._t_hi:
                self._t_hi = t + dt
        elif kind == EV_ASSIGN or kind == EV_REISSUE:
            self.n_dispatches += 1
            self.dispatch.add(dt)
            self.disp_p50.add(dt)
            self.disp_p99.add(dt)
            if kind == EV_REISSUE:
                self.n_duplicates += 1
                self.dup_rate.add(1.0)
            else:
                self.dup_rate.add(0.0)
        elif kind == EV_REPORT:
            self.reported_tasks += size
            self.finished += aux
            self.wasted_tasks += size - aux
            if size > 0:
                self.waste_rate.add((size - aux) / size)
        elif kind == EV_FF_SPAN:
            m = self._meter(wid)
            m.chunks += aux
            m.tasks += size
            m.busy += dt
            if size > 0 and aux > 0:
                # dt/size is the span's aggregate per-task cost; weight
                # it once per fast-forwarded chunk so Welford stays
                # comparable to the scalar path
                m.per_task.add(dt / size)
            self.busy_s += dt
            self.finished += start
            if t + dt > self._t_hi:
                self._t_hi = t + dt
        elif kind == EV_DEATH:
            self.deaths += 1
            self._meter(wid).alive = False

    # ---------------------------------------------------------- snapshot
    def span(self) -> tuple:
        if self._t_lo is math.inf:
            return (0.0, 0.0)
        return (self._t_lo, self._t_hi)

    def utilization(self) -> float:
        lo, hi = self.span()
        P = max(self.n_workers, len(self.workers), 1)
        dur = hi - lo
        return self.busy_s / (P * dur) if dur > 0 else 0.0

    def snapshot(self) -> dict:
        lo, hi = self.span()
        return dict(
            n_events=self.n_events,
            span=[lo, hi],
            dispatch_latency=dict(
                n=self.dispatch.n, mean=self.dispatch.mean,
                std=self.dispatch.std,
                p50=self.disp_p50.value(), p99=self.disp_p99.value()),
            h_estimate=self.disp_p50.value(),
            n_dispatches=self.n_dispatches,
            n_duplicates=self.n_duplicates,
            duplicate_rate_ewma=self.dup_rate.value or 0.0,
            finished=self.finished,
            reported_tasks=self.reported_tasks,
            wasted_tasks=self.wasted_tasks,
            waste_rate_ewma=self.waste_rate.value or 0.0,
            deaths=self.deaths,
            busy_s=self.busy_s,
            utilization=self.utilization(),
            workers={int(w): m.to_dict()
                     for w, m in sorted(self.workers.items())})


def run_telemetry(trace) -> dict:
    """Trace-derived run telemetry for embedding into emitted run
    records (``repro_torch run --trace --emit-json``).

    Unlike :class:`MetricsHub` this is the *exact* offline computation
    over a stored :class:`~repro_torch.core.trace.Trace` — np.percentile
    latencies, interval-overlap utilization — so the numbers a record
    carries match ``trace summarize`` on the companion trace file.
    """
    import numpy as np

    d = trace.dispatch_latency()
    u = trace.utilization(bins=50)
    c = trace.counters()
    t0, dur, wid = trace._busy_spans()
    busy: dict[int, float] = {}
    for w, s in zip(wid, dur):
        busy[int(w)] = busy.get(int(w), 0.0) + float(s)
    return dict(
        dispatch_latency=dict(n=d["n"], p50=d["p50"], p99=d["p99"],
                              mean=d["mean"], max=d["max"]),
        utilization_mean=float(np.mean(u["busy"])) if u["busy"] else 0.0,
        busy_s_by_worker={str(k): v for k, v in sorted(busy.items())},
        n_events=len(trace),
        duplicates=c["n_duplicates"],
        wasted_tasks=c["wasted_tasks"])
