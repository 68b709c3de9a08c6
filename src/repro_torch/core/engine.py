"""The unified self-scheduling ENGINE: one master-worker loop for all of
simulation, training, and serving.

The paper's claim is that a single mechanism — proactive duplicate
re-issue on idle time around a central ``RobustQueue`` — robustifies any
DLS execution.  The engine makes that literal in code: ONE implementation
of the request -> execute -> report loop, with worker liveness (fail-stop
by time or by task count), speed/latency perturbations, batch-weight
barrier polling, Fig.-1b hang surfacing, and unified metrics.  What the
tasks *are* is delegated to a small :class:`WorkerBackend`:

  * the discrete-event simulator is a backend whose ``execute`` does
    nothing (only nominal task costs matter) — the engine's virtual-time
    event loop IS the simulator;
  * ``rdlb.run_to_completion`` is the same loop with unit costs;
  * the training executor's backend computes per-microbatch gradients and
    commits them exactly-once by task id;
  * the serving executor's backend decodes request chunks (optionally as
    one padded, jitted batch) and commits first-completion-wins outputs.

Because every driver shares this loop, simulated and executed schedules
cannot drift apart: the same (technique, scenario, seed) produces the
same assignment log whether the backend computes real results or not
(the SimAS property — simulation-assisted selection requires the
simulator to drive the exact production scheduling path).

Two execution modes:

``Engine.run()``
    Deterministic virtual-time event loop (a heap of timed events, master
    transactions serialized with overhead ``h``, message latencies,
    fail-stop instants).  Causality is exact: a duplicate is only issued
    if, at that virtual instant, the original chunk is unfinished.

``Engine.run_threaded()``
    Real concurrency: one OS thread per worker, wall-clock time.  rDLB
    duplicates genuinely race their originals and first-completion-wins
    is physical, not an artifact of round-robin ordering.  Results are
    identical for deterministic backends (greedy decode, exactly-once
    grads); only attribution (who won) varies.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import threading
import time
from typing import Any, Optional

import numpy as np

from repro_torch.core import fastpath, rdlb
from repro_torch.core import trace as trc

# Event kinds.  *_ARRIVE are master-side (message already in flight —
# processed even if the sender died after sending); REQUEST/COMPLETE are
# worker-side.  Master transactions are serialized with overhead h and see
# the queue state AT ARRIVAL TIME (a perturbed worker's delayed message
# must not block healthy workers — the master is only busy h/transaction).
REQUEST, REQ_ARRIVE, COMPLETE, REP_ARRIVE = 0, 1, 2, 3


@dataclasses.dataclass
class EngineWorker:
    """Liveness/perturbation state of one worker (PE / replica / group).

    ``fail_time`` is a fail-stop instant measured on the run's clock:
    virtual seconds in ``Engine.run()``, WALL seconds from run start in
    ``run_threaded()`` (the thread dies at that instant, holding any
    in-flight chunk) and in the process runtime (SIGKILL —
    repro.cluster.chaos).  ``fail_after_tasks`` is a count-based
    fail-stop (executor fault plans: the worker dies at its next
    assignment once it has executed that many tasks, holding the
    chunk).  Both may be set.
    """
    wid: int
    speed: float = 1.0                      # <1.0 = straggler
    msg_latency: float = 0.0                # extra seconds per message
    fail_time: Optional[float] = None       # virtual fail-stop instant
    fail_after_tasks: Optional[int] = None  # count-based fail-stop
    sleep_per_task: float = 0.0             # threaded mode: injected delay
    alive: bool = True
    tasks_done: int = 0                     # executed, incl. wasted
    busy: float = 0.0                       # virtual compute seconds
    last_done: float = 0.0                  # instant of last completed chunk

    def alive_at(self, t: float) -> bool:
        return self.alive and (self.fail_time is None or t < self.fail_time)

    def fails_by_count(self) -> bool:
        return (self.fail_after_tasks is not None
                and self.tasks_done >= self.fail_after_tasks)


class WorkerBackend:
    """What a chunk of tasks *is*.  The engine owns scheduling; the
    backend owns execution and result reduction.

    ``execute`` runs the chunk and returns an opaque payload;
    ``cost`` is the chunk's nominal compute seconds on an unperturbed
    worker (the engine divides by worker speed);
    ``commit`` applies the payload for exactly the task ids this report
    newly finished (exactly-once / first-completion-wins reduction) —
    called under the engine's commit lock in threaded mode.
    """

    def execute(self, chunk: rdlb.Chunk, wid: int) -> Any:
        return None

    def cost(self, chunk: rdlb.Chunk, wid: int) -> float:
        return float(chunk.size)

    def commit(self, chunk: rdlb.Chunk, wid: int, payload: Any,
               newly: list[int]) -> None:
        pass


@dataclasses.dataclass
class EngineStats:
    """Unified per-run metrics, identical across all four drivers."""
    t_virtual: float             # virtual makespan (inf = hang); wall-clock
                                 # seconds in threaded mode
    hung: bool
    n_tasks: int
    n_finished: int
    n_assignments: int
    n_duplicates: int
    wasted_tasks: int            # task executions whose result was discarded
    by_worker: dict              # wid -> tasks executed (incl. wasted)
    worker_busy: np.ndarray      # per-worker compute seconds
    worker_idle: np.ndarray      # per-worker idle-before-termination seconds
    survivors: list              # wids alive at termination
    assignment_log: list         # every Chunk, in assignment order
    adaptive_decisions: list = dataclasses.field(default_factory=list)
                                 # DecisionRecords when an adaptive policy
                                 # watched the run (repro.adaptive)
    t_wall: float = 0.0          # wall-clock seconds for the whole run —
                                 # set in every mode, so virtual, threaded
                                 # and process runs are directly comparable
    chaos_events: list = dataclasses.field(default_factory=list)
                                 # per-worker ChaosEvent log (process mode:
                                 # real SIGKILL/SIGSTOP/throttle actions)
    fast_forwarded: int = 0      # chunks handled by the vectorized
                                 # fast-forward (repro_torch.core.fastpath);
                                 # 0 when the scalar event loop ran alone
    trace: Any = None            # finalized core.trace.Trace when the run
                                 # was recorded (ExecutionSpec.trace);
                                 # None otherwise — tracing is opt-in
    metrics: Any = None          # MetricsHub.snapshot() dict when live
                                 # telemetry was on (ExecutionSpec.metrics);
                                 # None otherwise — metering is opt-in

    @property
    def hang(self) -> bool:
        return self.hung

    def to_dict(self, *, include_log: bool = False,
                include_trace: bool = True) -> dict:
        """JSON-serializable run record (``python -m repro_torch run
        --emit-json``).  The assignment log is large and off by default;
        the trace rides along when present unless suppressed."""

        def _rec(x: Any) -> Any:
            f = getattr(x, "to_dict", None)
            if callable(f):
                return f()
            if dataclasses.is_dataclass(x) and not isinstance(x, type):
                return dataclasses.asdict(x)
            return repr(x)

        d = dict(
            t_virtual=(None if math.isinf(self.t_virtual)
                       else float(self.t_virtual)),
            hung=bool(self.hung), n_tasks=int(self.n_tasks),
            n_finished=int(self.n_finished),
            n_assignments=int(self.n_assignments),
            n_duplicates=int(self.n_duplicates),
            wasted_tasks=int(self.wasted_tasks),
            by_worker={str(k): int(v)
                       for k, v in sorted(self.by_worker.items())},
            worker_busy=np.asarray(self.worker_busy).tolist(),
            worker_idle=np.asarray(self.worker_idle).tolist(),
            survivors=[int(w) for w in self.survivors],
            t_wall=float(self.t_wall),
            fast_forwarded=int(self.fast_forwarded),
            adaptive_decisions=[_rec(x) for x in self.adaptive_decisions],
            chaos_events=[_rec(x) for x in self.chaos_events],
        )
        if include_log:
            d["assignment_log"] = [dataclasses.asdict(c)
                                   for c in self.assignment_log]
        if include_trace and self.trace is not None:
            d["trace"] = self.trace.to_dict()
        if self.metrics is not None:
            d["metrics"] = self.metrics
        return d


class Engine:
    """One self-scheduling master-worker loop around a RobustQueue.

    Parameters
    ----------
    queue:    the RobustQueue (owns DLS chunk sizing + rDLB re-issue).
    workers:  EngineWorker list (liveness, speed, latency, fail plans).
    backend:  WorkerBackend (execution + reduction).
    h:        master scheduling overhead per transaction (virtual seconds).
    horizon:  virtual-time bound; exceeding it reports a hang.
    record_feedback: feed (size, compute_time, sched_time) back into the
              technique on every report — the adaptive AWF-*/AF loop.
              Nonadaptive techniques ignore the measurements.
    max_fruitless_polls: consecutive idle polls (no assignment, no new
              completion) before the run is declared livelocked/hung —
              surfaces Fig. 1b instead of spinning to the horizon.
    adaptive: optional adaptive policy (duck-typed; see
              repro.adaptive.AdaptiveController).  ``bind(engine)`` is
              called once at run start, ``on_report(engine, t)`` after
              every master report transaction — the policy may snapshot
              the run and hot-swap the queue's technique/knobs there.
    """

    def __init__(self, queue: rdlb.RobustQueue,
                 workers: list[EngineWorker],
                 backend: WorkerBackend, *,
                 h: float = 1e-4,
                 horizon: float = 1e7,
                 record_feedback: bool = True,
                 max_fruitless_polls: Optional[int] = None,
                 adaptive: Any = None,
                 trace: Optional[trc.TraceRecorder] = None) -> None:
        self.queue = queue
        self.workers = workers
        self.backend = backend
        # Flight recorder (core.trace).  None when off — every emission
        # site below is a single ``if tr is not None`` guard, so the
        # untraced hot path pays one identity test per transaction and
        # allocates nothing.
        self.trace = trace
        self.h = h
        self.horizon = horizon
        self.record_feedback = record_feedback
        self.adaptive = adaptive
        P = len(workers)
        self._by_wid = {w.wid: w for w in workers}
        self.max_fruitless_polls = (max_fruitless_polls
                                    if max_fruitless_polls is not None
                                    else max(256, 64 * P))
        # threaded/process modes only bound stalls by poll COUNT when the
        # knob was set explicitly (the derived default is tuned for the
        # virtual event loop, where polls are free)
        self._fruitless_explicit = max_fruitless_polls is not None
        self.by_worker: dict[int, int] = {}
        # Append-log kept ONLY when the queue cannot produce its own
        # (ReferenceQueue oracle runs) — the array-native queue owns the
        # log, and retaining a second per-chunk object list would cost
        # exactly what the lazy ChunkLog saves.  Live introspection
        # should use ``queue.n_assignments`` / ``queue.chunk_log()``.
        self._keep_append_log = not hasattr(queue, "chunk_log")
        self.assignment_log: list[rdlb.Chunk] = []
        self._commit_lock = threading.Lock()
        # A base-class commit is a no-op: reports then only need the
        # newly-finished COUNT, not the id list (the timing-only hot path)
        self._trivial_commit = (type(backend).commit
                                is WorkerBackend.commit)
        self._ff_chunks = 0

    # --------------------------------------------------------------- common
    def _feedback(self, chunk: rdlb.Chunk, compute_time: float,
                  sched_time: float) -> None:
        if self.record_feedback:
            self.queue.record_feedback(chunk, compute_time, sched_time)

    def _execute(self, chunk: rdlb.Chunk, wid: int) -> Any:
        payload = self.backend.execute(chunk, wid)
        w = self._by_wid[wid]
        w.tasks_done += chunk.size
        self.by_worker[wid] = self.by_worker.get(wid, 0) + chunk.size
        return payload

    def _finalize_trace(self, mode: str, clock: str, **meta):
        """Seal the recorder into an immutable Trace (None when off).
        Adaptive decision points are folded in here — the controller
        already timestamps its DecisionRecords on the run's clock."""
        tr = self.trace
        if tr is None:
            return None
        if self.adaptive is not None:
            for d in getattr(self.adaptive, "decisions", ()):
                tr.event(trc.EV_DECISION, d.t, -1,
                         aux=int(bool(d.swapped)),
                         detail=f"{d.incumbent}->{d.chosen}")
        return tr.finalize(mode=mode, clock=clock,
                           n_tasks=self.queue.N,
                           n_workers=len(self.workers), **meta)

    def _hub_snapshot(self) -> Any:
        """Live-telemetry summary when a MetricsHub rode the recorder."""
        tr = self.trace
        if tr is None or tr.hub is None:
            return None
        return tr.hub.snapshot()

    def _stats(self, t_par: float, hung: bool,
               t_wall: float = 0.0, trace: Any = None) -> EngineStats:
        P = len(self.workers)
        busy = np.array([w.busy for w in self.workers])
        idle = np.zeros(P)
        if not math.isinf(t_par) and not hung:
            for i, w in enumerate(self.workers):
                end = min(t_par, w.fail_time if w.fail_time is not None
                          else t_par)
                if not w.alive and w.fail_time is None:
                    # Count-based fail-stop (or initially-dead worker):
                    # no fail instant exists, so clamp idle at the last
                    # completion — the worker stopped existing for the
                    # run at that point, not at t_par.
                    end = min(end, w.last_done)
                idle[i] = max(0.0, end - w.busy)
        q = self.queue
        # The array-native queue owns the full log (seq order by
        # construction, even under threaded racing — rows are written
        # under the queue lock).  The reference oracle keeps no log, so
        # fall back to the engine's append list, normalized to seq order
        # (threaded appends may race).
        log_fn = getattr(q, "chunk_log", None)
        log = (log_fn() if log_fn is not None
               else sorted(self.assignment_log, key=lambda c: c.seq))
        return EngineStats(
            t_virtual=t_par, hung=hung, n_tasks=q.N,
            n_finished=q.n_finished, n_assignments=q.n_assignments,
            n_duplicates=q.n_duplicates, wasted_tasks=q.wasted_tasks,
            by_worker=dict(self.by_worker), worker_busy=busy,
            worker_idle=idle,
            survivors=[w.wid for w in self.workers if w.alive],
            assignment_log=log,
            adaptive_decisions=(list(getattr(self.adaptive, "decisions",
                                             ()))
                                if self.adaptive is not None else []),
            t_wall=t_wall,
            fast_forwarded=self._ff_chunks,
            trace=trace,
            metrics=self._hub_snapshot())

    # ---------------------------------------------------- virtual-time mode
    def run(self) -> EngineStats:
        """Deterministic virtual-time event loop (the simulator's heart,
        now shared by every driver)."""
        queue = self.queue
        workers = self._by_wid
        h = self.h
        tr = self.trace
        wall0 = time.monotonic()
        if self.adaptive is not None:
            self.adaptive.bind(self)       # may re-plan at t=0
        master_free = 0.0
        t_done = math.inf
        fruitless = 0
        inflight = 0     # COMPLETE/REP_ARRIVE events guaranteed to arrive
        counter = itertools.count()          # heap tie-break

        # Vectorized fast-forward (repro_torch.core.fastpath): in the checked
        # homogeneous fixed-chunk regime, whole rounds are processed as
        # array recurrences and the scalar loop resumes from the
        # in-flight COMPLETE events it would have reached event-by-event.
        ff = (fastpath.fast_forward(self) if self.adaptive is None
              else None)
        if ff is not None:
            self._ff_chunks = ff.n_chunks
            master_free = ff.master_free
            heap = [(float(ff.complete_times[i]), next(counter), COMPLETE,
                     self.workers[i].wid,
                     queue.chunk_at(int(ff.inflight_seqs[i])), None)
                    for i in range(len(self.workers))]
            inflight = len(heap)
        else:
            # (time, tiebreak, kind, wid, chunk, payload)
            heap = [(0.0, next(counter), REQUEST, w.wid, None, None)
                    for w in self.workers]
        heapq.heapify(heap)

        def assign(wid: int, t_master: float,
                   t_arrival: float = math.nan) -> bool:
            """Master (busy until t_master) assigns work to ``wid``.
            Returns True iff an assignment was made.  ``t_arrival`` is
            when the triggering message reached the master — the gap to
            ``t_master`` is the transaction's dispatch latency (queueing
            behind the busy master + h)."""
            nonlocal master_free, inflight
            w = workers[wid]
            c = queue.request(wid)
            if c is None:
                if queue.done:
                    return False
                if queue.wait_hint == "barrier" or queue.rdlb_enabled:
                    # batch-weight barrier (clears when reports arrive —
                    # poll again, with or without rDLB) or rDLB duplicate
                    # cap.  Poll interval bounded below in absolute terms
                    # so idle workers cannot flood the event queue during
                    # a long stall.
                    poll = max(100 * h, 0.02)
                    heapq.heappush(heap, (t_master + poll, next(counter),
                                          REQUEST, wid, None, None))
                # else: non-robust + all scheduled: worker blocks forever
                # (paper Fig. 1b)
                return False
            if self._keep_append_log:
                self.assignment_log.append(c)
            if tr is not None:
                tr.event(trc.EV_REISSUE if c.duplicate else trc.EV_ASSIGN,
                         t_master, wid, c.seq, c.start, c.size,
                         aux=c.origin_seq,
                         dt=(t_master - t_arrival
                             if t_arrival == t_arrival else h))
            if w.fails_by_count():
                if tr is not None:
                    tr.event(trc.EV_DEATH, t_master, wid, c.seq, c.start,
                             c.size, detail="fail_after_tasks")
                w.alive = False               # dies holding the chunk
                return True
            reply_at = t_master + w.msg_latency   # chunk reaches worker
            done_at = reply_at + self.backend.cost(c, wid) / w.speed
            if w.fail_time is not None and done_at >= w.fail_time:
                if tr is not None:
                    tr.event(trc.EV_DEATH, w.fail_time, wid, c.seq,
                             c.start, c.size, detail="fail_time")
                w.alive = False               # dies mid-chunk
                return True
            payload = self._execute(c, wid)
            if tr is not None:
                tr.event(trc.EV_EXEC, reply_at, wid, c.seq, c.start,
                         c.size, aux=c.origin_seq, dt=done_at - reply_at)
            w.busy += done_at - reply_at
            w.last_done = done_at
            inflight += 1
            heapq.heappush(heap, (done_at, next(counter), COMPLETE,
                                  wid, c, payload))
            return True

        hung = False
        while heap:
            t, _, kind, wid, chunk, payload = heapq.heappop(heap)
            if t > self.horizon or fruitless > self.max_fruitless_polls:
                hung = True
                break
            w = workers[wid]

            if kind == REQUEST:                        # worker-side send
                if not w.alive_at(t):
                    if tr is not None and w.alive:
                        tr.event(trc.EV_DEATH,
                                 w.fail_time if w.fail_time is not None
                                 else t, wid, detail="fail_time")
                    w.alive = False
                    continue
                heapq.heappush(heap, (t + w.msg_latency, next(counter),
                                      REQ_ARRIVE, wid, None, None))
            elif kind == COMPLETE:                     # worker finished
                # (death mid-chunk is filtered at assign time)
                heapq.heappush(heap, (t + w.msg_latency, next(counter),
                                      REP_ARRIVE, wid, chunk, payload))
            elif kind == REQ_ARRIVE:                   # master transaction
                start = max(t, master_free)
                master_free = start + h
                if assign(wid, start + h, t):
                    fruitless = 0
                elif inflight == 0:
                    # No completion can ever arrive: only repeated polls
                    # (barrier-miss escalation) could still make progress.
                    fruitless += 1
            else:                                      # REP_ARRIVE
                start = max(t, master_free)
                master_free = start + h
                inflight -= 1
                if self._trivial_commit:
                    # no-op commit: skip materializing the id list
                    newly = queue.report_count(chunk)
                else:
                    newly = queue.report_tasks(chunk)
                    self.backend.commit(chunk, wid, payload, newly)
                compute = self.backend.cost(chunk, chunk.pe)
                compute /= workers[chunk.pe].speed
                if tr is not None:
                    n_new = newly if isinstance(newly, int) else len(newly)
                    tr.event(trc.EV_REPORT, start + h, wid, chunk.seq,
                             chunk.start, chunk.size, aux=n_new,
                             dt=compute)
                    if not self._trivial_commit:
                        tr.event(trc.EV_COMMIT, start + h, wid, chunk.seq,
                                 aux=n_new)
                self._feedback(chunk, compute, 2 * w.msg_latency + h)
                if newly:
                    fruitless = 0
                if queue.done and newly:
                    t_done = start + h         # master sees the last task
                    break                      # MPI_Abort analogue
                if self.adaptive is not None:
                    # Decision point: the policy may hot-swap the queue's
                    # technique/knobs BEFORE the piggybacked assignment,
                    # so the very next chunk is sized by the new plan.
                    self.adaptive.on_report(self, start + h)
                # DLS4LB piggybacks the next work request on the result
                # message: the same master transaction assigns the next
                # chunk.  (Count-based fail-stop triggers INSIDE assign —
                # the worker receives the chunk and dies holding it.)
                if w.alive_at(start + h):
                    assign(wid, start + h, t)

        done = queue.done and not hung
        t_par = t_done if done else math.inf
        return self._stats(t_par, not done,
                           t_wall=time.monotonic() - wall0,
                           trace=self._finalize_trace("virtual", "virtual"))

    # ------------------------------------------------------- threaded mode
    def run_threaded(self, *, poll: float = 1e-3,
                     stall_timeout: float = 5.0) -> EngineStats:
        """Real concurrency: one thread per worker; duplicates race in
        wall-clock time and first-completion-wins is physical.

        ``stall_timeout``: seconds a worker may poll fruitlessly (no
        global queue progress) before giving up — the Fig.-1b hang
        surfaced in finite time.  ``self.max_fruitless_polls`` bounds
        the same stall in poll COUNTS (the ExecutionSpec knob works in
        both engine modes): whichever limit trips first ends the wait.

        ``fail_time`` (and the spec layer's ``hang_time``, folded into
        it) is interpreted as WALL seconds from run start: the worker
        thread fail-stops at that instant — mid-chunk it dies holding
        the chunk (never reports), exactly like a killed process.

        With a storing recorder each worker thread's chunk runs under a
        :class:`core.trace.ChunkContext`, through which the serving
        executor records its group, prefill and step spans; the trace's
        ``meta["t0_unix_ns"]`` is the run's zero on the Unix clock.
        """
        queue = self.queue
        # The count-based bound must never undercut the wall-clock one
        # for default knobs: only an explicit ExecutionSpec override
        # (max_fruitless_polls is not None) tightens it.
        max_polls = (self.max_fruitless_polls if self._fruitless_explicit
                     else math.inf)
        tr = self.trace
        unix0 = time.time_ns()
        t0 = time.monotonic()
        t0_unix_ns = (unix0 + time.time_ns()) // 2
        errors: list[BaseException] = []
        if self.adaptive is not None:
            self.adaptive.bind(self)       # may re-plan before threads run

        def progress_mark() -> tuple:
            return (queue.n_finished, queue.n_assignments)

        def worker_loop(w: EngineWorker) -> None:
            last_progress = progress_mark()
            stall_start = None
            fruitless = 0
            ctx = (trc.ChunkContext(tr, t0, w.wid)
                   if tr is not None and tr.store else None)

            def failed_now() -> bool:
                if (w.fail_time is not None
                        and time.monotonic() - t0 >= w.fail_time):
                    w.alive = False
                    return True
                return False

            while True:
                if queue.done:
                    return
                if failed_now():
                    if tr is not None:
                        tr.event(trc.EV_DEATH, time.monotonic() - t0,
                                 w.wid, detail="fail_time")
                    return
                if tr is None:
                    chunk = queue.request(w.wid)
                else:
                    _rq0 = time.monotonic()
                    chunk = queue.request(w.wid)
                    _rq_lat = time.monotonic() - _rq0
                if chunk is None:
                    if queue.done:
                        return
                    # NOTE: don't consult queue.wait_hint here — it is a
                    # shared scratch field another thread's request() may
                    # clobber; the property derives barrier state fresh.
                    if queue.nonrobust_dead_end:
                        return        # non-robust: would block forever
                    mark = progress_mark()
                    if mark != last_progress:
                        last_progress, stall_start = mark, None
                        fruitless = 0
                    elif stall_start is None:
                        stall_start = time.monotonic()
                        fruitless = 1
                    else:
                        fruitless += 1
                        if (time.monotonic() - stall_start > stall_timeout
                                or fruitless > max_polls):
                            return    # livelock (e.g. capped dup on a
                                      # dead worker): surface the hang
                    time.sleep(poll)
                    continue
                stall_start = None
                fruitless = 0
                if self._keep_append_log:
                    with self._commit_lock:
                        self.assignment_log.append(chunk)
                if tr is not None:
                    tr.event(trc.EV_REISSUE if chunk.duplicate
                             else trc.EV_ASSIGN,
                             time.monotonic() - t0, w.wid, chunk.seq,
                             chunk.start, chunk.size,
                             aux=chunk.origin_seq, dt=_rq_lat)
                if w.fails_by_count():
                    if tr is not None:
                        tr.event(trc.EV_DEATH, time.monotonic() - t0,
                                 w.wid, chunk.seq, chunk.start,
                                 chunk.size, detail="fail_after_tasks")
                    w.alive = False   # dies holding the chunk
                    return
                t_exec0 = time.monotonic()
                if ctx is None:
                    payload = self.backend.execute(chunk, w.wid)
                else:
                    payload = ctx.run(chunk.seq, chunk.start,
                                      self.backend.execute, chunk, w.wid)
                if w.sleep_per_task > 0.0:
                    time.sleep(w.sleep_per_task * chunk.size)
                if failed_now():
                    if tr is not None:
                        tr.event(trc.EV_DEATH, time.monotonic() - t0,
                                 w.wid, chunk.seq, chunk.start,
                                 chunk.size, detail="fail_time")
                    return            # dies holding the chunk: the
                                      # report never happens, rDLB must
                                      # re-issue it elsewhere, and NO
                                      # work is credited (tasks_done /
                                      # by_worker count reported work
                                      # only — same as a killed process)
                dt_exec = time.monotonic() - t_exec0
                w.busy += dt_exec
                w.last_done = time.monotonic() - t0
                with self._commit_lock:
                    w.tasks_done += chunk.size
                    self.by_worker[w.wid] = (self.by_worker.get(w.wid, 0)
                                             + chunk.size)
                    newly = queue.report_tasks(chunk)
                    self.backend.commit(chunk, w.wid, payload, newly)
                    if tr is not None:
                        # EXEC is only credited at report time in this
                        # mode (work a worker dies holding never counts)
                        tr.event(trc.EV_EXEC, t_exec0 - t0, w.wid,
                                 chunk.seq, chunk.start, chunk.size,
                                 aux=chunk.origin_seq, dt=dt_exec)
                        tr.event(trc.EV_REPORT, time.monotonic() - t0,
                                 w.wid, chunk.seq, chunk.start,
                                 chunk.size, aux=len(newly), dt=dt_exec)
                    self._feedback(chunk, dt_exec, 0.0)
                if self.adaptive is not None and not queue.done:
                    # OUTSIDE the commit lock: a decision point may run a
                    # whole forecast sweep, which must not stall other
                    # workers' commits.  The controller serializes its
                    # own re-plans; snapshot/swap take the queue lock
                    # internally.  ``t`` is wall-clock seconds here.
                    self.adaptive.on_report(self, time.monotonic() - t0)

        def guarded(w: EngineWorker) -> None:
            try:
                worker_loop(w)
            except BaseException as e:      # surface after join — don't
                errors.append(e)            # misreport as a Fig.-1b hang

        threads = [threading.Thread(target=guarded, args=(w,),
                                    daemon=True)
                   for w in self.workers if w.alive]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        wall = time.monotonic() - t0
        hung = not queue.done
        return self._stats(math.inf if hung else wall, hung, t_wall=wall,
                           trace=self._finalize_trace(
                               "threaded", "wall", t0_unix_ns=t0_unix_ns))
