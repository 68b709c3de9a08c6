"""Flight recorder: event-level tracing for every execution mode.

The paper's claims are *timeline* claims — proactive re-issue fills the
idle time a failure creates (Fig. 1b vs 1c), rDLB overhead shrinks
quadratically with P — yet ``EngineStats`` only reports end-of-run
aggregates.  This module records the run itself: a low-overhead stream
of typed events (assignments, re-issues, executions, reports, worker
deaths/freezes, chaos actions, adaptive decisions, fast-forward bulk
segments) that every driver emits through one :class:`TraceRecorder`:

  * ``Engine.run()`` — virtual-time events, timestamps in virtual
    seconds;
  * ``Engine.run_threaded()`` — wall-clock seconds from run start;
  * the vectorized fast-forward (``core.fastpath``) — whole windows
    collapse into per-worker :data:`EV_FF_SPAN` bulk segments, so
    tracing never forces the scalar loop;
  * the process cluster (``repro.cluster``) — the master records its
    transactions, each worker records its executions locally and ships
    them over the existing AF_UNIX transport at report/teardown time,
    and the master aligns them onto its own clock (CLOCK_MONOTONIC is
    system-wide on this single-host testbed, so alignment is one offset
    subtraction: ``t_worker - t0_master``).  Two-level group masters
    relay worker trace messages upward exactly like errors.

Zero-cost when off: drivers hold ``trace=None`` and every emission site
is a single ``if tr is not None`` guard — no allocation, no call.  When
on, an event is one tuple append into a chunked columnar buffer (blocks
of ``CHUNK_EVENTS`` rows are sealed into numpy arrays as they fill, so
a million-event run never holds a million Python tuples).

The finalized :class:`Trace` is the substrate everything else derives
from:

  * ``counters()`` reconstructs ``n_assignments`` / ``n_duplicates`` /
    ``wasted_tasks`` / ``by_worker`` exactly (asserted against
    ``EngineStats`` in virtual, threaded AND process modes —
    tests/test_trace.py);
  * ``to_chrome()`` exports Chrome-trace-event / Perfetto-compatible
    JSON: one lane per worker plus a master lane, duplicate and wasted
    chunks visually flagged, chaos actions as instants;
  * time-sliced metrics: ``utilization()``, ``queue_depth()``,
    ``chunk_sizes()``, ``overhead_decomposition()``,
    ``dispatch_latency()`` (per-transaction p50/p99 — replacing the
    wall-clock-delta estimate ``benchmarks/fig_cluster.py`` used).
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Any, Optional

import numpy as np

__all__ = [
    "EV_ASSIGN", "EV_REISSUE", "EV_EXEC", "EV_REPORT", "EV_COMMIT",
    "EV_DEATH", "EV_FREEZE", "EV_THAW", "EV_CHAOS", "EV_DECISION",
    "EV_FF_SPAN", "EVENT_NAMES", "TraceRecorder", "Trace",
    "to_chrome", "save_chrome", "load_trace", "summarize", "diff",
]

TRACE_VERSION = 1

# Event kinds.  One record is the 8-column row
#   (kind, t, wid, seq, start, size, aux, dt)  [+ optional detail str]
# with per-kind field semantics:
#
#   EV_ASSIGN    master hands an ORIGINAL chunk to ``wid``.  t = master
#                transaction end, (seq, start, size) identify the chunk,
#                aux = origin_seq (== seq), dt = dispatch latency (time
#                from the request's arrival at the master to the assign).
#   EV_REISSUE   same, but an rDLB duplicate; aux = the ORIGINAL seq.
#   EV_EXEC      ``wid`` executed the chunk: t = execution start,
#                dt = duration.  Virtual mode synthesizes it at assign
#                time (the event loop knows [reply, done] exactly);
#                threaded mode emits it at report time (work a worker
#                dies holding is never credited — engine semantics);
#                process mode records it IN the worker and ships it.
#   EV_REPORT    a report transaction committed: t = commit instant,
#                wid = reporting worker, aux = tasks NEWLY finished
#                (size - aux = wasted), dt = reported compute seconds.
#                detail (two-level mode only) = JSON {wid: executed}.
#   EV_COMMIT    backend.commit applied a payload (non-trivial backends
#                only); aux = len(newly).
#   EV_DEATH     worker fail-stop: seq/size = the chunk it died holding
#                (seq -1 = idle), detail = reason.
#   EV_FREEZE /  process-mode SIGSTOP / SIGCONT (virtual and threaded
#   EV_THAW      modes fold hangs into deaths — to the master they are
#                the same event).
#   EV_CHAOS     any other real chaos action (duty-cycle throttle...);
#                detail = action description.
#   EV_DECISION  adaptive re-plan: aux = 1 if the technique was swapped,
#                detail = "incumbent->chosen".
#   EV_FF_SPAN   one worker's share of a fast-forwarded window: t = span
#                start, dt = span duration, aux = chunks fast-forwarded,
#                size = tasks assigned, start = tasks bulk-FINISHED
#                inside the window (the in-flight round reports through
#                the scalar tail as ordinary EV_REPORTs).
(EV_ASSIGN, EV_REISSUE, EV_EXEC, EV_REPORT, EV_COMMIT, EV_DEATH,
 EV_FREEZE, EV_THAW, EV_CHAOS, EV_DECISION, EV_FF_SPAN) = range(11)

EVENT_NAMES = ("assign", "reissue", "exec", "report", "commit", "death",
               "freeze", "thaw", "chaos", "decision", "ff_span")

#: rows per sealed columnar block
CHUNK_EVENTS = 1 << 16

_COLS = ("kind", "t", "wid", "seq", "start", "size", "aux", "dt")
_DTYPES = dict(kind=np.int8, t=np.float64, wid=np.int32, seq=np.int64,
               start=np.int64, size=np.int64, aux=np.int64, dt=np.float64)


class TraceRecorder:
    """Chunked, thread-safe event buffer (the hot-path side).

    ``event()`` is the one append primitive: it builds a single row
    tuple and appends it under a small lock (uncontended in the virtual
    event loop; threaded/process handler threads share it).  When the
    pending list reaches :data:`CHUNK_EVENTS` rows it is sealed into
    columnar numpy arrays, so long runs hold blocks of typed columns,
    not millions of tuples.

    Drivers hold ``trace=None`` when tracing is off and guard every
    emission with ``if tr is not None`` — the recorder itself is never
    consulted on an untraced run.

    ``hub`` is an optional :class:`repro.obs.metrics.MetricsHub`: every
    event (including rows merged from worker processes) is streamed into
    it under the same lock, so any driver that can trace can meter.
    ``store=False`` runs the recorder metrics-only: events feed the hub
    but no rows are retained and ``finalize`` returns None — live
    telemetry without the memory cost of a stored trace.
    """

    __slots__ = ("meta", "hub", "store", "_pending", "_details",
                 "_blocks", "_lock")

    def __init__(self, meta: Optional[dict] = None, hub=None,
                 store: bool = True) -> None:
        self.meta = dict(meta or {})
        self.hub = hub
        self.store = store
        self._pending: list = []
        self._details: dict[int, str] = {}   # global row index -> detail
        self._blocks: list = []              # sealed column dicts
        self._lock = threading.Lock()

    # ------------------------------------------------------------ append
    def event(self, kind: int, t: float, wid: int, seq: int = -1,
              start: int = -1, size: int = 0, aux: int = 0,
              dt: float = 0.0, detail: Optional[str] = None) -> None:
        if not self.store:                       # metrics-only fast path
            with self._lock:
                if self.hub is not None:
                    self.hub.observe(kind, t, wid, seq, start, size,
                                     aux, dt)
            return
        row = (kind, float(t), int(wid), int(seq), int(start),
               int(size), int(aux), float(dt))
        with self._lock:
            if self.hub is not None:
                self.hub.observe(*row)
            if detail is not None:
                n = (len(self._blocks) * CHUNK_EVENTS
                     + len(self._pending))
                self._details[n] = detail
            self._pending.append(row)
            if len(self._pending) >= CHUNK_EVENTS:
                self._seal_locked()

    def _seal_locked(self) -> None:
        if not self._pending:
            return
        rows = np.array(self._pending, dtype=np.float64)
        self._blocks.append({
            c: rows[:, i].astype(_DTYPES[c])
            for i, c in enumerate(_COLS)})
        self._pending = []

    # --------------------------------------------- cross-process plumbing
    def drain(self) -> list:
        """Detach and return every pending raw row (worker side: ship
        over the transport at report/teardown time).  Single-producer
        usage — the worker loop is the only appender."""
        with self._lock:
            out = self._pending
            if self._details:
                out = [r + (self._details.get(
                    len(self._blocks) * 0 + i),) for i, r in
                    enumerate(out)]
                self._details = {}
            self._pending = []
            return out

    def merge_raw(self, rows, offset: float = 0.0) -> None:
        """Absorb shipped raw rows (master side), shifting timestamps by
        ``offset`` onto the master's clock."""
        with self._lock:
            for r in rows:
                detail = r[8] if len(r) > 8 else None
                row = (int(r[0]), float(r[1]) + offset, int(r[2]),
                       int(r[3]), int(r[4]), int(r[5]), int(r[6]),
                       float(r[7]))
                if self.hub is not None:
                    self.hub.observe(*row)
                if not self.store:
                    continue
                if detail is not None:
                    self._details[len(self._blocks) * CHUNK_EVENTS
                                  + len(self._pending)] = detail
                self._pending.append(row)
                if len(self._pending) >= CHUNK_EVENTS:
                    self._seal_locked()

    @property
    def n_events(self) -> int:
        with self._lock:
            return len(self._blocks) * CHUNK_EVENTS + len(self._pending)

    # ---------------------------------------------------------- finalize
    def finalize(self, **meta) -> Optional["Trace"]:
        """Seal everything and return the immutable :class:`Trace`,
        sorted by timestamp (stable, so same-instant events keep their
        emission order).  Metrics-only recorders (``store=False``)
        return None — the hub's snapshot is the run's output."""
        if not self.store:
            return None
        with self._lock:
            self._seal_locked()
            blocks, details = self._blocks, dict(self._details)
            m = dict(self.meta)
        m.update(meta)
        if blocks:
            cols = {c: np.concatenate([b[c] for b in blocks])
                    for c in _COLS}
        else:
            cols = {c: np.zeros(0, dtype=_DTYPES[c]) for c in _COLS}
        order = np.argsort(cols["t"], kind="stable")
        remap = {int(old): i for i, old in enumerate(order)}
        cols = {c: a[order] for c, a in cols.items()}
        details = {remap[i]: s for i, s in details.items()
                   if i in remap}
        return Trace(details=details, meta=m, **cols)


@dataclasses.dataclass
class Trace:
    """A finalized run trace: parallel columns, one row per event.

    ``meta`` carries at least ``mode`` ("virtual" | "threaded" |
    "process"), ``clock`` ("virtual" | "wall"), and ``n_tasks``.
    """
    kind: np.ndarray
    t: np.ndarray
    wid: np.ndarray
    seq: np.ndarray
    start: np.ndarray
    size: np.ndarray
    aux: np.ndarray
    dt: np.ndarray
    details: dict
    meta: dict

    def __len__(self) -> int:
        return len(self.kind)

    def _of(self, *kinds: int) -> np.ndarray:
        return np.isin(self.kind, kinds)

    # -------------------------------------------------- reconstruction
    def counters(self) -> dict:
        """Reconstruct the run's aggregate counters from the stream.

        Exact parity with ``EngineStats`` is the recorder's core
        invariant: ``n_assignments``, ``n_duplicates``,
        ``wasted_tasks``, ``n_finished`` and ``by_worker`` here must
        equal the queue's own accounting in every mode.
        """
        is_assign = self.kind == EV_ASSIGN
        is_dup = self.kind == EV_REISSUE
        is_rep = self.kind == EV_REPORT
        is_ff = self.kind == EV_FF_SPAN
        n_assignments = int(is_assign.sum() + is_dup.sum()
                            + self.aux[is_ff].sum())
        n_duplicates = int(is_dup.sum())
        wasted = int((self.size[is_rep] - self.aux[is_rep]).sum())
        n_finished = int(self.aux[is_rep].sum()
                         + self.start[is_ff].sum())
        by: dict[int, int] = {}
        if self.meta.get("mode") == "virtual":
            # the engine credits work at execution time (a worker that
            # dies holding a chunk never executed it); fast-forwarded
            # windows credit their full assigned share
            for m in (self.kind == EV_EXEC, is_ff):
                for w, s in zip(self.wid[m], self.size[m]):
                    by[int(w)] = by.get(int(w), 0) + int(s)
        else:
            # threaded/process: credited at report time (engine
            # semantics — dying after execute but before report credits
            # nothing); two-level reports carry a JSON by-dict detail
            for i in np.flatnonzero(is_rep):
                d = self.details.get(int(i))
                if d is not None and d.startswith("{"):
                    for k, v in json.loads(d).items():
                        by[int(k)] = by.get(int(k), 0) + int(v)
                else:
                    w = int(self.wid[i])
                    by[w] = by.get(w, 0) + int(self.size[i])
        return dict(n_assignments=n_assignments,
                    n_duplicates=n_duplicates,
                    wasted_tasks=wasted,
                    n_finished=n_finished,
                    fast_forwarded=int(self.aux[is_ff].sum()),
                    by_worker=by)

    # ----------------------------------------------- time-sliced metrics
    def _busy_spans(self):
        """(t0, dur, wid) of every execution span incl. FF segments."""
        m = self._of(EV_EXEC, EV_FF_SPAN)
        return self.t[m], self.dt[m], self.wid[m]

    def span(self) -> tuple:
        """(t_min, t_max) covered by the trace (busy spans included)."""
        if not len(self):
            return (0.0, 0.0)
        t0, dur, _ = self._busy_spans()
        hi = float(self.t.max())
        if len(t0):
            hi = max(hi, float((t0 + dur).max()))
        return (float(self.t.min()), hi)

    def utilization(self, bins: int = 100) -> dict:
        """Fraction of worker-seconds spent computing, per time slice.

        Returns ``{"edges": [bins+1], "busy": [bins]}`` where ``busy``
        is summed worker-busy seconds per slice divided by P × slice
        width — the utilization timeline Fig. 1's idle-time story is
        about.
        """
        lo, hi = self.span()
        P = max(1, int(self.meta.get("n_workers")
                       or (int(self.wid.max()) + 1 if len(self) else 1)))
        edges = np.linspace(lo, max(hi, lo + 1e-12), bins + 1)
        t0, dur, _ = self._busy_spans()
        busy = np.zeros(bins)
        if len(t0):
            width = edges[1] - edges[0]
            # vectorized interval overlap: clip each span against every
            # slice it touches
            for i in range(bins):
                a, b = edges[i], edges[i + 1]
                busy[i] = np.clip(np.minimum(t0 + dur, b)
                                  - np.maximum(t0, a), 0.0, None).sum()
            busy /= max(width * P, 1e-300)
        return {"edges": edges.tolist(), "busy": busy.tolist()}

    def queue_depth(self) -> dict:
        """Scheduled-frontier and in-flight trajectories over time.

        Returns step series ``{"t": [...], "unscheduled": [...],
        "inflight": [...]}`` sampled at every assign/report/ff event.
        Original assignments move the frontier; reports retire tasks.
        """
        N = int(self.meta.get("n_tasks", 0))
        m = self._of(EV_ASSIGN, EV_REPORT, EV_FF_SPAN)
        idx = np.flatnonzero(m)
        t = self.t[idx]
        kinds = self.kind[idx]
        sched = np.where(kinds == EV_ASSIGN, self.size[idx],
                         np.where(kinds == EV_FF_SPAN, self.size[idx], 0))
        fin = np.where(kinds == EV_REPORT, self.aux[idx],
                       np.where(kinds == EV_FF_SPAN, self.start[idx], 0))
        csched = np.cumsum(sched)
        cfin = np.cumsum(fin)
        return {"t": t.tolist(),
                "unscheduled": (N - csched).tolist(),
                "inflight": (csched - cfin).tolist()}

    def chunk_sizes(self) -> list:
        """Original-chunk sizes in assignment order — the technique's
        chunk-size trajectory (FF windows contribute their fixed chunk
        as aux equal-size chunks, summarized as one entry)."""
        out = []
        for i in np.flatnonzero(self._of(EV_ASSIGN, EV_FF_SPAN)):
            if self.kind[i] == EV_ASSIGN:
                out.append(int(self.size[i]))
            else:
                n, tot = int(self.aux[i]), int(self.size[i])
                if n > 0:
                    out.extend([tot // n] * n)
        return out

    def overhead_decomposition(self) -> dict:
        """Where the executed work went: useful vs duplicate vs wasted.

        ``wasted_time`` apportions each report's compute time over its
        tasks (a chunk whose report won k of s tasks wasted (s-k)/s of
        its duration).
        """
        is_rep = self.kind == EV_REPORT
        size = self.size[is_rep].astype(float)
        new = self.aux[is_rep].astype(float)
        dts = self.dt[is_rep]
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = np.where(size > 0, (size - new) / size, 0.0)
        busy = float(self.dt[self._of(EV_EXEC, EV_FF_SPAN)].sum())
        c = self.counters()
        return dict(n_duplicates=c["n_duplicates"],
                    wasted_tasks=c["wasted_tasks"],
                    duplicate_assign_tasks=int(
                        self.size[self.kind == EV_REISSUE].sum()),
                    wasted_time=float((dts * frac).sum()),
                    reported_time=float(dts.sum()),
                    busy_time=busy)

    def dispatch_latency(self) -> dict:
        """Per-transaction dispatch latency (request arrival -> assign)
        percentiles — the measurement ``fig_cluster`` previously
        inferred from a wall-clock delta divided by N."""
        m = self._of(EV_ASSIGN, EV_REISSUE)
        lat = self.dt[m]
        if not len(lat):
            return dict(n=0, p50=0.0, p99=0.0, mean=0.0, max=0.0)
        return dict(n=int(len(lat)),
                    p50=float(np.percentile(lat, 50)),
                    p99=float(np.percentile(lat, 99)),
                    mean=float(lat.mean()),
                    max=float(lat.max()))

    # ------------------------------------------------------ serialization
    def to_dict(self) -> dict:
        ints = dict(kind="kind", wid="wid", seq="seq", start="start",
                    size="size", aux="aux")
        cols: dict[str, list] = {
            k: getattr(self, a).tolist() for k, a in ints.items()}
        cols["t"] = self.t.tolist()
        cols["dt"] = self.dt.tolist()
        return dict(version=TRACE_VERSION, meta=dict(self.meta),
                    n_events=len(self), columns=cols,
                    details={str(k): v for k, v in self.details.items()})

    @classmethod
    def from_dict(cls, d: dict) -> "Trace":
        cols = d.get("columns", {})
        n = len(cols.get("kind", ()))
        kw = {c: np.asarray(cols.get(c, np.zeros(n)), dtype=_DTYPES[c])
              for c in _COLS}
        return cls(details={int(k): v
                            for k, v in d.get("details", {}).items()},
                   meta=dict(d.get("meta", {})), **kw)


# ---------------------------------------------------------------- exporter
#: Chrome-trace color names for flagged slices (catapult's palette)
_CNAME_DUP = "bad"          # duplicate chunk: orange
_CNAME_WASTED = "terrible"  # chunk whose report won nothing: red

_TID_MASTER = 0


def _tid(wid: int) -> int:
    return int(wid) + 1


def to_chrome(trace: Trace) -> dict:
    """Chrome-trace-event / Perfetto JSON for one run.

    One lane per worker plus a master lane.  Worker lanes carry
    execution spans (duplicates orange, fully-wasted chunks red) and
    death/freeze/chaos instants; the master lane carries assign
    transactions (dispatch latency as the slice duration), report
    instants, adaptive decisions, and fast-forward bulk segments are
    drawn in their worker's lane.  Timestamps are microseconds: virtual
    seconds × 1e6 for virtual-time runs, wall seconds × 1e6 otherwise
    (the ``clock`` meta key records which).

    The full raw trace rides along under the top-level ``"repro"`` key
    (Perfetto ignores unknown keys), so an exported file is also a
    lossless archive ``python -m repro_torch trace summarize`` can re-derive
    every metric from.
    """
    meta = trace.meta
    clock = meta.get("clock", "virtual")
    evs: list[dict] = []
    pid = 0
    evs.append({"ph": "M", "pid": pid, "name": "process_name",
                "args": {"name": f"rdlb {meta.get('mode', 'run')} "
                                 f"({clock} time)"}})
    evs.append({"ph": "M", "pid": pid, "tid": _TID_MASTER,
                "name": "thread_name", "args": {"name": "master"}})
    wids = sorted({int(w) for w in trace.wid if w >= 0})
    for w in wids:
        evs.append({"ph": "M", "pid": pid, "tid": _tid(w),
                    "name": "thread_name", "args": {"name": f"worker {w}"}})
        evs.append({"ph": "M", "pid": pid, "tid": _tid(w),
                    "name": "thread_sort_index", "args": {"sort_index": w}})

    # reports that won nothing -> flag the matching exec span red
    is_rep = trace.kind == EV_REPORT
    wasted_seqs = set(
        trace.seq[is_rep & (trace.aux == 0) & (trace.size > 0)].tolist())

    us = 1e6
    for i in range(len(trace)):
        k = int(trace.kind[i])
        t = float(trace.t[i]) * us
        w = int(trace.wid[i])
        seq = int(trace.seq[i])
        detail = trace.details.get(i)
        if k == EV_EXEC:
            dup = seq != int(trace.aux[i])
            name = (f"{'dup ' if dup else ''}chunk {seq} "
                    f"[{int(trace.start[i])}..{int(trace.start[i]) + int(trace.size[i])})")
            ev = {"ph": "X", "pid": pid, "tid": _tid(w), "ts": t,
                  "dur": float(trace.dt[i]) * us, "name": name,
                  "cat": "exec",
                  "args": {"seq": seq, "size": int(trace.size[i]),
                           "duplicate": dup}}
            if seq in wasted_seqs:
                ev["cname"] = _CNAME_WASTED
                ev["args"]["wasted"] = True
            elif dup:
                ev["cname"] = _CNAME_DUP
            evs.append(ev)
        elif k == EV_FF_SPAN:
            evs.append({"ph": "X", "pid": pid, "tid": _tid(w), "ts": t,
                        "dur": float(trace.dt[i]) * us, "cat": "exec",
                        "name": (f"fast-forward ×{int(trace.aux[i])} "
                                 f"chunks ({int(trace.size[i])} tasks)"),
                        "args": {"chunks": int(trace.aux[i]),
                                 "tasks": int(trace.size[i]),
                                 "bulk_finished": int(trace.start[i])}})
        elif k in (EV_ASSIGN, EV_REISSUE):
            dur = float(trace.dt[i]) * us
            ev = {"ph": "X", "pid": pid, "tid": _TID_MASTER,
                  "ts": t - dur, "dur": dur, "cat": "master",
                  "name": (f"{'reissue' if k == EV_REISSUE else 'assign'}"
                           f" {seq}→w{w}"),
                  "args": {"seq": seq, "wid": w,
                           "size": int(trace.size[i]),
                           "origin_seq": int(trace.aux[i])}}
            if k == EV_REISSUE:
                ev["cname"] = _CNAME_DUP
            evs.append(ev)
        elif k == EV_REPORT:
            evs.append({"ph": "i", "pid": pid, "tid": _TID_MASTER,
                        "ts": t, "s": "t", "cat": "master",
                        "name": f"report {seq} (+{int(trace.aux[i])})",
                        "args": {"seq": seq, "wid": w,
                                 "newly": int(trace.aux[i]),
                                 "wasted": int(trace.size[i])
                                 - int(trace.aux[i])}})
        elif k in (EV_DEATH, EV_FREEZE, EV_THAW, EV_CHAOS):
            name = {EV_DEATH: "death", EV_FREEZE: "freeze",
                    EV_THAW: "thaw", EV_CHAOS: "chaos"}[k]
            if detail:
                name = f"{name}: {detail}"
            evs.append({"ph": "i", "pid": pid,
                        "tid": _tid(w) if w >= 0 else _TID_MASTER,
                        "ts": t, "s": "g", "cat": "chaos", "name": name,
                        "args": {"wid": w, "seq": seq}})
        elif k == EV_DECISION:
            evs.append({"ph": "i", "pid": pid, "tid": _TID_MASTER,
                        "ts": t, "s": "p", "cat": "adaptive",
                        "name": (f"decision: {detail or ''}"
                                 + (" (swapped)" if trace.aux[i] else "")),
                        "args": {"swapped": bool(trace.aux[i])}})
        elif k == EV_COMMIT:
            evs.append({"ph": "i", "pid": pid, "tid": _TID_MASTER,
                        "ts": t, "s": "t", "cat": "master",
                        "name": f"commit {seq} ({int(trace.aux[i])})",
                        "args": {"seq": seq, "newly": int(trace.aux[i])}})
    return {"traceEvents": evs, "displayTimeUnit": "ms",
            "otherData": {"source": "repro flight recorder",
                          "clock": clock,
                          "mode": meta.get("mode", "")},
            "repro": trace.to_dict()}


def save_chrome(trace: Trace, path) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome(trace), f)
        f.write("\n")


def load_trace(path) -> Trace:
    """Read a trace back from an exported Chrome JSON file (the raw
    records ride under the ``"repro"`` key), a bare ``Trace.to_dict()``
    JSON dump, or an emitted run record whose ``"trace"`` key carries
    the dump (``repro run --emit-json`` with tracing on)."""
    with open(path) as f:
        d = json.load(f)
    if "repro" in d:
        d = d["repro"]
    elif isinstance(d.get("trace"), dict) and "columns" in d["trace"]:
        d = d["trace"]
    if "columns" not in d:
        raise ValueError(f"{path} carries no repro trace records")
    return Trace.from_dict(d)


# ----------------------------------------------------------------- summaries
def summarize(trace: Trace) -> str:
    """Human-readable digest of one trace (the CLI's ``trace
    summarize``)."""
    c = trace.counters()
    d = trace.dispatch_latency()
    o = trace.overhead_decomposition()
    lo, hi = trace.span()
    u = trace.utilization(bins=20)
    mean_util = float(np.mean(u["busy"])) if u["busy"] else 0.0
    lines = [
        f"trace: {len(trace)} events, mode={trace.meta.get('mode', '?')}, "
        f"clock={trace.meta.get('clock', '?')}, span=[{lo:.4f}, {hi:.4f}]s",
        f"counters: assignments={c['n_assignments']} "
        f"duplicates={c['n_duplicates']} finished={c['n_finished']} "
        f"wasted_tasks={c['wasted_tasks']} "
        f"fast_forwarded={c['fast_forwarded']}",
        f"by_worker: {json.dumps({str(k): v for k, v in sorted(c['by_worker'].items())})}",
        f"dispatch_latency: n={d['n']} p50={d['p50']:.6f}s "
        f"p99={d['p99']:.6f}s mean={d['mean']:.6f}s",
        f"overhead: busy={o['busy_time']:.4f}s "
        f"wasted_time={o['wasted_time']:.4f}s "
        f"dup_assigned_tasks={o['duplicate_assign_tasks']}",
        f"utilization: mean={mean_util:.3f} over 20 slices",
    ]
    deaths = np.flatnonzero(trace._of(EV_DEATH, EV_FREEZE, EV_CHAOS))
    for i in deaths[:20]:
        lines.append(
            f"chaos: t={trace.t[i]:.4f}s wid={int(trace.wid[i])} "
            f"{EVENT_NAMES[int(trace.kind[i])]}"
            + (f" ({trace.details[int(i)]})"
               if int(i) in trace.details else ""))
    if len(deaths) > 20:
        lines.append(f"chaos: ... {len(deaths) - 20} more")
    return "\n".join(lines)


def diff(a: Trace, b: Trace) -> str:
    """Counter/latency delta between two traces (``trace diff``)."""
    ca, cb = a.counters(), b.counters()
    da, db = a.dispatch_latency(), b.dispatch_latency()
    rows = [("events", len(a), len(b))]
    for k in ("n_assignments", "n_duplicates", "n_finished",
              "wasted_tasks", "fast_forwarded"):
        rows.append((k, ca[k], cb[k]))
    for k in ("p50", "p99"):
        rows.append((f"dispatch_{k}_s", round(da[k], 6), round(db[k], 6)))
    out = []
    for k, va, vb in rows:
        mark = "" if va == vb else "   <- differs"
        out.append(f"{k}: {va} vs {vb}{mark}")
    return "\n".join(out)
