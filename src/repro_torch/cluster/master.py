"""Process-cluster master: real OS workers around the same RobustQueue.

Port of ``repro.cluster.master``.  ``ClusterRun`` is the process-mode
counterpart of ``repro_torch.core.engine.Engine``: it drives the
IDENTICAL ``RobustQueue``
(same ``request``/``report_tasks`` transactions, same rDLB re-issue,
same exactly-once flag accounting) but its workers are real child
processes speaking the protocol over a socket, and its perturbations
are real signals compiled by ``repro_torch.cluster.chaos``.

Where parity ends and physics begins
------------------------------------
The queue is shared, so the *original-chunk partition* of [0, N) — the
sequence of (start, size) pairs the technique produces — is identical to
``Engine.run()`` for techniques whose chunk sizing depends only on the
remaining-task count (SS/FAC/GSS/...; duplicates never move the
frontier), and every task completes exactly once in both worlds.  What
the virtual twin can only *model*, this runtime *performs*: which worker
wins a duplicate race, how long a SIGSTOPped process stays invisible,
what a kill does to an in-flight socket — wall-clock physics, not
simulation.  Hence the parity tests compare the original-chunk partition
and the completion set, never wall-clock attribution.

Two-level mode (``ExecutionSpec.n_groups > 1``): the top-level queue
schedules group-sized chunks to GROUP MASTERS (one process each); a
group master self-schedules its chunk task-by-task to its local worker
subset with local re-issue, and reports the chunk upward when complete.
rDLB at the top level re-issues ACROSS groups, so losing an entire
group (master + workers) is survivable — the two-level hierarchy of
Mohammed et al., with the paper's robustness at both levels.  The top
master spawns ALL processes (workers included), so chaos injection and
guaranteed teardown stay centralized.

Teardown is unconditional: a ``finally`` block SIGCONTs anything frozen,
kills every child, joins (reaps) them, and removes the socket dir —
a hung, errored, or interrupted run leaves no orphans and no zombies,
reporting ``hung=True`` through ``EngineStats`` instead of deadlocking.

On the card
-----------
A runner whose tasks launch kernels declares ``start_method = "spawn"``
(and ``device = "cuda"``): its children are fresh interpreters, each
with a CUDA context of its own — a forked child of a process that has
initialised CUDA cannot use the card.  Before spawning them the master
builds the kernel library once (``kernels._build.library()``; loading
it creates no CUDA context), so no child compiles, and children started
on a stale tree would serialise on the build's file lock anyway.  A
runner with large state (weights, a batch) defines ``ship(dir)``, which
writes that state into the run's directory and returns the light
runner that is pickled for the children.

What each run leaves for inspection (``runs()``, reset by
``reset_runs()``): its wall seconds, the bytes the master received from
its children, its chaos events, and per child its pid, the seconds
from spawn to its first assignment and the latest ``("kernels", ...)``
report it sent (``cluster.worker.kernel_info``: kernel path, launch
and event counts, peak card memory).
"""

from __future__ import annotations

import json
import math
import multiprocessing
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from typing import Any, Optional

import numpy as np

from repro_torch.cluster import transport
from repro_torch.cluster.chaos import ChaosController
from repro_torch.cluster.worker import (FnRunner, NullRunner, SleepRunner,
                                        worker_main)
from repro_torch.core import engine, rdlb
from repro_torch.core import trace as trc

# Grace period before stall detection may fire while NO assignment has
# been made yet: spawned children may be importing torch and loading
# weights onto the card (seconds), which is startup latency, not a
# Fig.-1b stall.
STARTUP_GRACE = 60.0

_runs_lock = threading.Lock()
_RUNS: list = []


def runs() -> list:
    """Summaries of the process-mode runs since :func:`reset_runs`, in
    order (see the module docstring)."""
    with _runs_lock:
        return list(_RUNS)


def reset_runs() -> None:
    with _runs_lock:
        _RUNS.clear()


def factory_for_backend(backend: Any) -> Any:
    """Derive a child-side runner from a master-side WorkerBackend.

    SimBackend/FnBackend-with-task-times → real sleeps of the nominal
    durations (one virtual second = one wall second); FnBackend with a
    picklable ``task_fn`` → execute it in the child; anything else →
    no-op execution (pure scheduling).  Executors pass explicit runners
    (repro_torch.cluster.runners) instead.  A ``task_fn`` that computes
    on the card gets a spawning runner (``FnRunner.start_method``).
    """
    from repro_torch.core.simulator import SimBackend
    from repro_torch.runtime.backends import FnBackend
    if isinstance(backend, SimBackend):
        return SleepRunner(task_times=np.diff(backend._ctime))
    if isinstance(backend, FnBackend):
        tt = (np.diff(backend._ctime) if backend._ctime is not None
              else None)
        if backend.task_fn is not None:
            return FnRunner(backend.task_fn, task_times=tt)
        if tt is not None:
            return SleepRunner(task_times=tt)
    return NullRunner()


def _child_env() -> dict:
    """Environment for fresh-interpreter children: they rebuild sys.path
    from PYTHONPATH, so the repro_torch source root must be on it
    absolutely (the parent may have been launched with a relative
    PYTHONPATH from another cwd, or with ``sys.path`` edited in place)."""
    import repro_torch
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env = dict(os.environ)
    parts = env.get("PYTHONPATH", "")
    if src not in parts.split(os.pathsep):
        env["PYTHONPATH"] = src + os.pathsep + parts if parts else src
    return env


def _start_quietly(p) -> None:
    """Start a forked child without Python's warning that forking a
    multi-threaded process may deadlock the child.

    These children run no CUDA and take torch's intra-op work on one
    thread (``worker_main``); anything that uses the card declares
    ``start_method = "spawn"`` and gets a fresh interpreter instead.
    """
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=r".*fork\(\)")
        p.start()


class _PopenHandle:
    """Process-handle adapter: subprocess children with the same
    surface the teardown code uses on multiprocessing ones."""

    def __init__(self, popen: subprocess.Popen):
        self._p = popen
        self.pid = popen.pid

    def is_alive(self) -> bool:
        return self._p.poll() is None

    def terminate(self) -> None:
        self._p.terminate()

    def kill(self) -> None:
        self._p.kill()

    def join(self, timeout: Optional[float] = None) -> None:
        try:
            self._p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass


class _Client:
    """Master-side record of one connected protocol peer (a worker in
    single-level mode, a group master in two-level mode)."""

    def __init__(self, wid: int, pid: int, conn: transport.Connection):
        self.wid = wid
        self.pid = pid
        self.conn = conn
        self.clean_exit = False      # we sent ("done",) to this peer
        self.gone = False            # connection closed / peer dead
        self.inflight = 0            # chunks assigned, not yet reported
        self.fruitless = 0           # consecutive no-progress polls
        self.last_mark = None        # queue progress at last poll


class ClusterRun:
    """One process-mode execution: spawn, schedule, perturb, reap.

    Duck-types the slice of ``Engine`` the drivers rely on: ``queue``,
    ``workers`` (EngineWorker bookkeeping — executors seed
    ``tasks_done`` and read back ``alive``), and ``run() -> EngineStats``.
    Construction is cheap and side-effect free (``--dry-run`` builds
    specs without spawning anything); all processes live inside
    ``run()``.
    """

    def __init__(self, queue: rdlb.RobustQueue, spec,
                 backend: engine.WorkerBackend, *,
                 factory: Any = None,
                 record_feedback: bool = True,
                 trace: Optional[trc.TraceRecorder] = None) -> None:
        self.queue = queue
        self.spec = spec
        self.backend = backend
        # Flight recorder (core.trace).  The master records its own
        # transactions directly; workers record their execution spans
        # in-process and ship them over the transport (see
        # cluster.worker) — merged here with monotonic-clock offset
        # alignment.  None = tracing off, zero instrumentation cost.
        self.trace = trace
        self._t0 = 0.0
        self.factory = (factory if factory is not None
                        else factory_for_backend(backend))
        self.record_feedback = record_feedback
        self.workers = spec.cluster.engine_workers()
        self._by_wid = {w.wid: w for w in self.workers}
        self.by_worker: dict[int, int] = {}
        self.assignment_log: list = []
        self._lock = threading.Lock()          # log + by_worker + commit
        e = spec.execution
        P = spec.cluster.n_workers
        if e.n_groups > P:
            raise ValueError(f"n_groups={e.n_groups} > n_workers={P}")
        if e.n_groups > 1 and e.wall_timeout is None:
            raise ValueError(
                "two-level mode needs a finite execution.wall_timeout: "
                "the top master cannot distinguish a computing group "
                "from a frozen one (it cannot see inside groups, by "
                "design), so stall detection alone cannot bound a "
                "whole-group hang")
        fast = [wid for wid, w in enumerate(spec.cluster.worker_specs())
                if w.speed > 1.0]
        if fast:
            raise ValueError(
                f"workers {fast} declare speed > 1, which the process "
                "runtime cannot physically realize (a real process "
                "cannot run faster than nominal); rescale the cluster "
                "so the fastest worker has speed 1.0")
        if e.n_groups > 1:
            for w in spec.cluster.worker_specs():
                if w.fail_after_tasks is not None:
                    raise ValueError(
                        "fail_after_tasks is a per-assignment action "
                        "the TOP master applies; in two-level mode "
                        "assignments happen inside groups — use "
                        "fail_time/hang_time instead")
                if w.msg_latency:
                    raise ValueError(
                        "msg_latency is realized on the master<->worker "
                        "transport, which in two-level mode is the "
                        "group-internal link the top master does not "
                        "own; per-worker latency is not supported with "
                        "n_groups > 1")

    # ------------------------------------------------------------ helpers
    def _group_layout(self) -> Optional[list]:
        G = self.spec.execution.n_groups
        if G <= 1:
            return None
        P = self.spec.cluster.n_workers
        return [list(r) for r in np.array_split(np.arange(P), G)]

    # ---------------------------------------------------------- protocol
    def _handle_request(self, cl: _Client, chaos: ChaosController,
                        two_level: bool) -> None:
        queue, e = self.queue, self.spec.execution
        tr = self.trace
        t_req = time.monotonic() if tr is not None else 0.0
        if queue.done:
            cl.clean_exit = True
            cl.conn.send(("done",))
            return
        w = self._by_wid.get(cl.wid) if not two_level else None
        chunk = queue.request(cl.wid)
        if chunk is None:
            if queue.done:
                cl.clean_exit = True
                cl.conn.send(("done",))
                return
            if queue.nonrobust_dead_end:
                # non-robust dead end (paper Fig. 1b): this peer can
                # never receive work again — release it; the monitor
                # loop reports the hang once every peer is drained.
                cl.clean_exit = True
                cl.conn.send(("done",))
                return
            # per-peer consecutive no-progress polls, mirroring the
            # threaded loop's semantics for the same ExecutionSpec knob:
            # a peer that exceeds the bound gives up (released like the
            # dead end above); the drained monitor reports the hang
            mark = (queue.n_finished, queue.n_assignments)
            if mark != cl.last_mark:
                cl.last_mark, cl.fruitless = mark, 1
            else:
                cl.fruitless += 1
            if cl.fruitless > self._max_fruitless:
                cl.clean_exit = True
                cl.conn.send(("done",))
                return
            cl.conn.send(("wait", e.poll))
            return
        with self._lock:
            self.assignment_log.append(chunk)
        cl.fruitless = 0
        if tr is not None:
            now = time.monotonic()
            tr.event(trc.EV_REISSUE if chunk.duplicate else trc.EV_ASSIGN,
                     now - self._t0, cl.wid, chunk.seq, chunk.start,
                     chunk.size, aux=chunk.origin_seq, dt=now - t_req)
        if w is not None and w.fails_by_count():
            # count-based fail-stop: the worker receives the chunk and
            # dies holding it — enforced here because the master owns
            # the task accounting (the worker cannot count for itself
            # what the scheduler considers "executed").
            if tr is not None:
                tr.event(trc.EV_DEATH, time.monotonic() - self._t0,
                         cl.wid, chunk.seq, chunk.start, chunk.size,
                         detail="fail_after_tasks")
            w.alive = False
            chaos.kill(cl.wid, action="kill_by_count",
                       detail=f"fail_after_tasks={w.fail_after_tasks}")
            return
        cl.inflight += 1             # counted only when actually sent
        if not two_level:            # group masters are not children
            self._first_assign.setdefault(cl.wid, time.monotonic())
        cl.conn.send(("assign", chunk))

    def _handle_report(self, cl: _Client, msg, t0: float,
                       done_evt: threading.Event,
                       two_level: bool) -> None:
        _, wid, chunk, payload, dt, by = msg
        cl.inflight = max(0, cl.inflight - 1)
        newly = self.queue.report_tasks(chunk)
        tr = self.trace
        if tr is not None:
            # two-level reports attribute executed work to the group's
            # REAL workers through ``by``; carry it as a JSON detail so
            # trace-side by_worker reconstruction matches the stats
            default_by = {wid: chunk.size}
            tr.event(trc.EV_REPORT, time.monotonic() - self._t0, wid,
                     chunk.seq, chunk.start, chunk.size, aux=len(newly),
                     dt=dt,
                     detail=(None if (by or default_by) == default_by
                             else json.dumps({str(k): int(v)
                                              for k, v in by.items()})))
        with self._lock:
            self.backend.commit(chunk, wid, payload, newly)
            if self.record_feedback:
                self.queue.record_feedback(chunk, dt, 0.0)
            for k, v in (by or {}).items():
                self.by_worker[k] = self.by_worker.get(k, 0) + v
        # per-worker liveness bookkeeping is worker-granular; in
        # two-level mode ``wid`` is a GROUP id, so only the merged
        # ``by`` counts above attribute work to real workers
        w = self._by_wid.get(wid) if not two_level else None
        if w is not None:
            w.tasks_done += chunk.size
            w.busy += dt
            w.last_done = time.monotonic() - t0
        if self.queue.done:
            done_evt.set()

    def _serve_client(self, conn: transport.Connection, chaos,
                      two_level: bool, t0: float,
                      done_evt: threading.Event,
                      closing: threading.Event,
                      errors: list) -> None:
        hello = conn.recv()
        if not hello or hello[0] != "hello":
            conn.close()
            return
        cl = _Client(hello[1], hello[2], conn)
        if not two_level:
            w = self._by_wid.get(cl.wid)
            if w is not None:
                conn.delay = w.msg_latency
        with self._lock:
            self._clients[cl.wid] = cl
            self._n_connected += 1
            self._n_active += 1
        try:
            while True:
                msg = conn.recv()
                if msg is None:                       # EOF: peer gone
                    if (not closing.is_set() and not cl.clean_exit
                            and not self.queue.done and not two_level):
                        w = self._by_wid.get(cl.wid)
                        if w is not None:
                            w.alive = False
                    return
                kind = msg[0]
                if kind == "request":
                    self._handle_request(cl, chaos, two_level)
                elif kind == "report":
                    self._handle_report(cl, msg, t0, done_evt, two_level)
                elif kind == "kernels":
                    with self._lock:
                        self._kernels[msg[1]] = msg[2]
                elif kind == "trace":
                    # worker-recorded spans, absolute monotonic stamps:
                    # shift onto the master's run clock (single host —
                    # CLOCK_MONOTONIC is shared, alignment is an offset)
                    if self.trace is not None:
                        self.trace.merge_raw(msg[2], offset=-self._t0)
                elif kind == "error":
                    errors.append((msg[1], msg[2]))
                    if two_level:
                        continue     # a RELAYED local-worker error: the
                                     # group master itself is still fine
                    w = self._by_wid.get(cl.wid)
                    if w is not None:
                        w.alive = False
                    return
        except transport.TransportError:
            # peer vanished mid-transaction (e.g. died between its
            # request and our assign): same liveness consequence as a
            # plain EOF
            if (not closing.is_set() and not cl.clean_exit
                    and not self.queue.done and not two_level):
                w = self._by_wid.get(cl.wid)
                if w is not None:
                    w.alive = False
            return
        finally:
            cl.gone = True
            with self._lock:
                self._n_active -= 1

    def _record_run(self, wall: float, hung: bool, pids: dict,
                    clients: list, chaos: ChaosController) -> None:
        children = {}
        for wid, pid in pids.items():
            first = self._first_assign.get(wid)
            children[wid] = dict(
                pid=pid, kernels=self._kernels.get(wid),
                spawn_to_first_assign_s=(
                    None if first is None
                    else first - self._spawned_at[wid]))
        with _runs_lock:
            _RUNS.append(dict(
                wall_s=wall, hung=hung,
                payload_bytes=sum(cl.conn.bytes_received for cl in clients),
                chaos=[ev.to_dict() for ev in chaos.events],
                children=children))

    # ---------------------------------------------------------------- run
    def run(self) -> engine.EngineStats:
        spec, queue = self.spec, self.queue
        e = spec.execution
        ws = spec.cluster.worker_specs()
        groups = self._group_layout()
        two_level = groups is not None
        # Light runners fork (fast, closure-friendly, no CUDA in the
        # child).  Heavy runners (start_method="spawn": they use the
        # card) get a FRESH interpreter via ``python -m
        # repro_torch.cluster._child`` — not multiprocessing's spawn,
        # whose __main__ re-execution breaks plain scripts.
        heavy = getattr(self.factory, "start_method", "fork") == "spawn"
        ctx = multiprocessing.get_context("fork")
        if heavy and getattr(self.factory, "device", "cpu") == "cuda":
            from repro_torch.kernels import _build   # no torch, no CUDA
            _build.library()

        tmp = tempfile.mkdtemp(prefix="rdlb-cluster-")
        top_addr = os.path.join(tmp, "master.sock")
        lsock = transport.listen(top_addr)
        lsock.settimeout(0.2)

        done_evt = threading.Event()
        closing = threading.Event()
        errors: list = []
        self._clients: dict[int, _Client] = {}
        self._n_connected = 0
        self._n_active = 0
        self._max_fruitless = (e.max_fruitless_polls
                               if e.max_fruitless_polls is not None
                               else math.inf)
        self._spawned_at: dict[int, float] = {}
        self._first_assign: dict[int, float] = {}
        self._kernels: dict[int, dict] = {}

        procs: list = []
        worker_pids: dict[int, int] = {}
        handler_threads: list = []
        hung = False
        t0 = time.monotonic()
        wall: Optional[float] = None
        chaos = ChaosController(ws, {}, seed=spec.scheduling.seed)
        child_env = _child_env() if heavy else None

        factory_path = os.path.join(tmp, "factory.pkl")
        if heavy:
            # ONE shared factory pickle, its large state (weights,
            # batches) shipped beside it by the runner's ship(); each
            # worker's own args file stays a few bytes
            ship = getattr(self.factory, "ship", None)
            shipped = ship(tmp) if callable(ship) else self.factory
            with open(factory_path, "wb") as f:
                pickle.dump(shipped, f, protocol=pickle.HIGHEST_PROTOCOL)

        def spawn_worker(address: str, wid: int):
            tracing = self.trace is not None
            self._spawned_at[wid] = time.monotonic()
            if heavy:
                path = os.path.join(tmp, f"worker{wid}.pkl")
                with open(path, "wb") as f:
                    pickle.dump(dict(address=address, wid=wid,
                                     factory_path=factory_path,
                                     sleep_per_task=ws[wid].sleep_per_task,
                                     poll=e.poll, trace=tracing), f)
                return _PopenHandle(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.cluster._child",
                     path],
                    env=child_env))
            p = ctx.Process(target=worker_main,
                            args=(address, wid, self.factory,
                                  ws[wid].sleep_per_task, e.poll,
                                  tracing),
                            daemon=True)
            _start_quietly(p)
            return p

        try:
            # -------------------------------------------------- spawn
            if two_level:
                n_clients = len(groups)
                gaddrs = {}
                for gid in range(len(groups)):
                    gaddrs[gid] = os.path.join(tmp, f"group{gid}.sock")
                    p = ctx.Process(
                        target=group_master_main,
                        args=(top_addr, gid, gaddrs[gid], e.poll,
                              queue.rdlb_enabled, queue.max_duplicates),
                        daemon=True)
                    procs.append(p)
                    _start_quietly(p)
                for gid, members in enumerate(groups):
                    for wid in members:
                        if ws[wid].alive:
                            p = spawn_worker(gaddrs[gid], wid)
                            procs.append(p)
                            worker_pids[wid] = p.pid
            else:
                n_clients = sum(1 for w in ws if w.alive)
                for wid, w in enumerate(ws):
                    if w.alive:
                        p = spawn_worker(top_addr, wid)
                        procs.append(p)
                        worker_pids[wid] = p.pid

            # chaos compiles the spec's perturbations into signals on
            # the REAL worker pids (group masters are never perturbed
            # directly — losing one is modeled by killing its workers)
            chaos = ChaosController(ws, worker_pids,
                                    seed=spec.scheduling.seed)
            t0 = time.monotonic()
            self._t0 = t0          # trace clock zero; the acceptor (and
                                   # hence every handler) starts after
                                   # this, so no event predates it
            chaos.start(t0)

            # ------------------------------------------------- accept
            def accept_loop():
                while not closing.is_set():
                    try:
                        sock, _ = lsock.accept()
                    except (TimeoutError, OSError):
                        continue
                    th = threading.Thread(
                        target=self._serve_client,
                        args=(transport.Connection(sock), chaos,
                              two_level, t0, done_evt, closing, errors),
                        daemon=True)
                    handler_threads.append(th)
                    th.start()

            acceptor = threading.Thread(target=accept_loop, daemon=True)
            acceptor.start()

            # ------------------------------------------------ monitor
            last_mark = (queue.n_finished, queue.n_assignments)
            last_t = t0
            while not done_evt.wait(0.02):
                now = time.monotonic()
                if (e.wall_timeout is not None
                        and now - t0 > e.wall_timeout):
                    hung = True
                    break
                mark = (queue.n_finished, queue.n_assignments)
                if mark != last_mark:
                    last_mark, last_t = mark, now
                    continue
                # A chunk in flight on a LIVE peer (connection open,
                # not killed/frozen by chaos) is presumed computing,
                # not stalled — the threaded loop likewise only accrues
                # stall while workers poll fruitlessly.  Only when
                # every unreported chunk is held by a dead/frozen peer
                # may the stall clock run.  (A group master counts as a
                # live holder: the top master cannot see inside a
                # group — by design — so whole-group loss without rDLB
                # is bounded by wall_timeout, not stall detection.)
                with self._lock:
                    # chaos.killed/stopped contain WORKER wids; in
                    # two-level mode clients are GROUP masters (a
                    # different id namespace, never chaos targets), so
                    # the chaos exclusion applies single-level only
                    live_inflight = any(
                        cl.inflight > 0 and not cl.gone
                        and not cl.clean_exit
                        and (two_level
                             or (cl.wid not in chaos.killed
                                 and cl.wid not in chaos.stopped))
                        for cl in self._clients.values())
                if live_inflight:
                    last_t = now
                    continue
                # grace keyed on the first COMPLETION, not the first
                # assignment: in two-level mode group masters take
                # chunks within milliseconds while their spawn-heavy
                # workers are still importing torch — an assignment alone
                # doesn't prove startup is over
                stall = (e.stall_timeout if queue.n_finished > 0
                         else max(STARTUP_GRACE, e.stall_timeout))
                if now - last_t > stall:
                    hung = True
                    break
                with self._lock:
                    drained = (self._n_connected >= n_clients
                               and self._n_active == 0)
                if drained and not queue.done:
                    hung = True        # every peer exited; no progress
                    break              # possible (Fig. 1b surfaced)
            # capture the run's wall time HERE — teardown (kill + reap
            # of every child) must not inflate t_wall comparisons
            wall = time.monotonic() - t0
        finally:
            # -------------------------------------- guaranteed teardown
            closing.set()
            done_evt.set()
            chaos.stop()               # SIGCONT anything frozen
            try:
                lsock.close()
            except OSError:
                pass
            with self._lock:
                clients = list(self._clients.values())
            for cl in clients:
                cl.conn.close()        # unblock handler recv()s
            for p in procs:
                if p.is_alive():
                    p.terminate()
            deadline = time.monotonic() + 5.0
            for p in procs:
                p.join(timeout=max(0.1, deadline - time.monotonic()))
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=2.0)
            for th in handler_threads:
                th.join(timeout=1.0)
            shutil.rmtree(tmp, ignore_errors=True)

        if wall is None:               # an exception skipped the capture
            wall = time.monotonic() - t0
        self._record_run(wall, hung or not queue.done, worker_pids,
                         clients, chaos)
        if errors:
            # same contract as Engine.run_threaded: a worker exception
            # is the caller's bug, not a Fig.-1b perturbation — raise it
            # (after teardown) instead of folding it into hung
            raise RuntimeError(
                "worker process error(s): "
                + "; ".join(f"wid {wid}: {r}" for wid, r in errors))
        hung = hung or not queue.done
        for wid in chaos.killed | chaos.stopped:
            self._by_wid[wid].alive = False
        P = len(self.workers)
        trace_final = None
        if self.trace is not None:
            # fold the REAL chaos actions in (kill_by_count deaths were
            # already recorded at their assignment transaction)
            for ev in chaos.events:
                if ev.action == "kill":
                    self.trace.event(trc.EV_DEATH, ev.t, ev.wid,
                                     detail=ev.detail or "SIGKILL")
                elif ev.action == "stop":
                    self.trace.event(trc.EV_FREEZE, ev.t, ev.wid,
                                     detail=ev.detail)
                elif ev.action != "kill_by_count":
                    self.trace.event(trc.EV_CHAOS, ev.t, ev.wid,
                                     detail=f"{ev.action}: {ev.detail}")
            trace_final = self.trace.finalize(
                mode="process", clock="wall", n_tasks=queue.N,
                n_workers=P)
        return engine.EngineStats(
            t_virtual=(math.inf if hung else wall), hung=hung,
            n_tasks=queue.N, n_finished=queue.n_finished,
            n_assignments=queue.n_assignments,
            n_duplicates=queue.n_duplicates,
            wasted_tasks=queue.wasted_tasks,
            by_worker=dict(self.by_worker),
            worker_busy=np.array([w.busy for w in self.workers]),
            worker_idle=np.zeros(P),
            survivors=[w.wid for w in self.workers if w.alive],
            # normalize to the queue's transaction order: handler
            # threads append after request() releases the queue lock,
            # so racing appends may interleave out of seq order
            assignment_log=sorted(self.assignment_log,
                                  key=lambda c: c.seq),
            adaptive_decisions=[],
            t_wall=wall,
            chaos_events=list(chaos.events),
            trace=trace_final,
            metrics=(self.trace.hub.snapshot()
                     if self.trace is not None
                     and self.trace.hub is not None else None))


# ----------------------------------------------------------- group master
def group_master_main(top_address: str, gid: int, listen_path: str,
                      poll: float, rdlb_enabled: bool = True,
                      max_duplicates: Optional[int] = None) -> None:
    """Two-level middle tier: one group master process.

    Upward it is indistinguishable from a worker (hello / request /
    report on the global queue); downward it is a miniature master,
    self-scheduling its current chunk task-by-task to local workers
    with local re-issue (a frozen local worker's task goes to an idle
    sibling; first local completion wins).  If the whole group stalls,
    it simply never reports — and the TOP-level rDLB re-issues the
    chunk to another group.  Robustness composes across both levels.

    The robustness knobs apply at BOTH levels: with ``rdlb_enabled``
    off local re-issue is disabled too (the paper's non-robust baseline
    must stay non-robust inside groups), and ``max_duplicates`` caps
    local re-issues per task — a capped task held by a dead local
    worker stalls only the group; top-level rDLB still re-issues the
    chunk across groups.
    """
    up = transport.connect(top_address)
    up_lock = threading.Lock()      # main loop + error relays share `up`
    lsock = transport.listen(listen_path)
    lsock.settimeout(0.2)
    lock = threading.Condition()
    state = {
        "chunk": None, "pending": [], "inflight": [], "done": set(),
        "payload": {}, "by": {}, "dt": 0.0, "seq": 0, "rptr": 0,
        "dups": {}, "shutdown": False,
    }

    def next_assignment(wid: int):
        if state["pending"]:
            t = state["pending"].pop(0)
            state["inflight"].append(t)
            dup = False
        else:
            if not rdlb_enabled:
                return None          # non-robust: no local re-issue
            live = [t for t in state["inflight"]
                    if t not in state["done"]
                    and (max_duplicates is None
                         or state["dups"].get(t, 0) < max_duplicates)]
            if not live:
                return None
            state["rptr"] = state["rptr"] % len(live)
            t = live[state["rptr"]]
            state["rptr"] += 1
            state["dups"][t] = state["dups"].get(t, 0) + 1
            dup = True
        mini = rdlb.Chunk(t, 1, wid, state["seq"], duplicate=dup)
        state["seq"] += 1
        return mini

    def handler(conn: transport.Connection) -> None:
        hello = conn.recv()
        if not hello or hello[0] != "hello":
            conn.close()
            return
        try:
            while True:
                msg = conn.recv()
                if msg is None:
                    return
                if msg[0] == "request":
                    with lock:
                        if state["shutdown"]:
                            conn.send(("done",))
                            return
                        mini = (next_assignment(msg[1])
                                if state["chunk"] is not None else None)
                    if mini is None:
                        conn.send(("wait", poll))
                    else:
                        conn.send(("assign", mini))
                elif msg[0] == "report":
                    _, wid, mini, payload, dt, by = msg
                    with lock:
                        # by/dt record EXECUTED work (incl. wasted
                        # local duplicates and stale reports) — merge
                        # them unconditionally so EngineStats.by_worker
                        # keeps its "executed incl. wasted" meaning
                        state["dt"] += dt
                        for k, v in (by or {}).items():
                            state["by"][k] = state["by"].get(k, 0) + v
                        t = mini.start
                        cur = state["chunk"]
                        # completion accounting accepts only tasks of
                        # the CURRENT chunk: a late local-duplicate
                        # report from an earlier chunk must not pollute
                        # this chunk's done-set/payload
                        if (cur is not None
                                and cur.start <= t < cur.stop
                                and t not in state["done"]):
                            state["done"].add(t)
                            state["payload"].update(payload or {})
                            if (len(state["done"])
                                    == state["chunk"].size):
                                lock.notify_all()
                elif msg[0] == "trace":
                    # relay worker-recorded spans upward untouched —
                    # the TOP master owns clock alignment (one shared
                    # CLOCK_MONOTONIC, one offset)
                    with up_lock:
                        up.send(msg)
                elif msg[0] == "error":
                    # relay the local worker's exception to the TOP
                    # master so the run_threaded re-raise contract
                    # holds through the hierarchy
                    with up_lock:
                        up.send(("error", msg[1], msg[2]))
                    return
        except transport.TransportError:
            return

    def accept_loop():
        while True:
            with lock:
                if state["shutdown"]:
                    return
            try:
                sock, _ = lsock.accept()
            except (TimeoutError, OSError):
                continue
            threading.Thread(target=handler,
                             args=(transport.Connection(sock),),
                             daemon=True).start()

    threading.Thread(target=accept_loop, daemon=True).start()

    try:
        with up_lock:
            up.send(("hello", gid, os.getpid()))
        while True:
            with up_lock:
                up.send(("request", gid))
            msg = up.recv()
            if msg is None or msg[0] == "done":
                break
            if msg[0] == "wait":
                time.sleep(msg[1])
                continue
            chunk = msg[1]
            with lock:
                state.update(chunk=chunk, pending=list(chunk.tasks()),
                             inflight=[], done=set(), payload={}, by={},
                             dt=0.0, rptr=0, dups={})
                while (len(state["done"]) < chunk.size
                       and not state["shutdown"]):
                    lock.wait(timeout=0.1)
                if state["shutdown"]:
                    return
                payload, dt, by = (dict(state["payload"]), state["dt"],
                                   dict(state["by"]))
                state["chunk"] = None
            with up_lock:
                up.send(("report", gid, chunk, payload, dt, by))
    except transport.TransportError:
        pass
    finally:
        with lock:
            state["shutdown"] = True
            lock.notify_all()
        try:
            lsock.close()
        except OSError:
            pass
        up.close()
