"""Chaos layer: compile ClusterSpec perturbations into real OS actions.

The virtual-time engine *models* perturbations; this module *performs*
them on live worker processes, so the paper's P−1 fault-tolerance claim
becomes physical:

  =====================  =========================================
  WorkerSpec field        OS action
  =====================  =========================================
  ``fail_time``           SIGKILL at t (fail-stop; process vanishes)
  ``fail_after_tasks``    SIGKILL at the next assignment once the
                          count is reached (applied by the master,
                          which owns the task accounting — the worker
                          receives the chunk and dies holding it)
  ``hang_time``           SIGSTOP at t (paper Fig. 1b: frozen, not
                          dead — the process survives until teardown)
  ``speed < 1``           SIGSTOP/SIGCONT duty cycle: the process
                          runs ``speed`` of every period
  ``msg_latency``         transport delay (repro_torch.cluster.transport)
  ``sleep_per_task``      worker-side injected delay (worker loop)
  =====================  =========================================

All timers are deterministic given the spec (offsets are fixed instants
from run start; the duty cycle has a fixed period and phase derived
from the seed), so a chaos schedule is as reproducible as the ClusterSpec
that declared it.  Every action is recorded as a :class:`ChaosEvent`
(surfaced on ``EngineStats.chaos_events``) so process runs can be
compared action-for-action against what the virtual twin predicted.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Optional

DUTY_PERIOD = 0.05     # seconds per SIGSTOP/SIGCONT throttle cycle


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One real OS action applied to a worker process."""
    t: float             # seconds since run start
    wid: int
    action: str          # "kill" | "stop" | "throttle" | "kill_by_count"
    detail: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _signal(pid: int, sig: int) -> bool:
    try:
        os.kill(pid, sig)
        return True
    except (ProcessLookupError, PermissionError):
        return False


class ChaosController:
    """Drives the timed perturbations of one cluster run.

    ``pids`` maps wid -> OS pid for every spawned worker.  ``start(t0)``
    arms one timer thread per scheduled action (plus one duty-cycle
    thread per throttled worker); ``stop()`` disarms everything and
    SIGCONTs anything left stopped so teardown can reap it.
    """

    def __init__(self, worker_specs, pids: dict, *, seed: int = 0):
        self.worker_specs = worker_specs
        self.pids = dict(pids)
        self.seed = seed
        self.events: list = []
        self.killed: set = set()
        self.stopped: set = set()
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._threads: list = []
        self._t0 = 0.0

    # ------------------------------------------------------------ record
    def _record(self, wid: int, action: str, detail: str = "") -> None:
        with self._lock:
            self.events.append(ChaosEvent(
                t=time.monotonic() - self._t0, wid=wid, action=action,
                detail=detail))

    def kill(self, wid: int, *, action: str = "kill",
             detail: str = "") -> None:
        """SIGKILL a worker now (also used by the master for
        count-based fail-stops, which fire at assignment time)."""
        pid = self.pids.get(wid)
        if pid is None:
            return
        with self._lock:
            # check-and-add under the lock: a fail_time timer and a
            # count-based kill racing each other must record ONE event
            if wid in self.killed:
                return
            self.killed.add(wid)
            _signal(pid, signal.SIGKILL)
        self._record(wid, action, detail)

    def _stop(self, wid: int) -> None:
        pid = self.pids.get(wid)
        if pid is None or wid in self.killed:
            return
        # lock-serialized against the duty-cycle thread: once ``wid``
        # is in ``stopped`` no throttle SIGCONT may thaw the freeze
        with self._lock:
            ok = _signal(pid, signal.SIGSTOP)
            if ok:
                self.stopped.add(wid)
        if ok:
            self._record(wid, "stop", "SIGSTOP (Fig. 1b freeze)")

    # ------------------------------------------------------------- timers
    def _at(self, delay: float, fn, *args) -> None:
        def timer():
            deadline = self._t0 + delay
            while not self._stop_evt.is_set():
                left = deadline - time.monotonic()
                if left <= 0:
                    fn(*args)
                    return
                self._stop_evt.wait(min(left, 0.05))
        th = threading.Thread(target=timer, daemon=True)
        self._threads.append(th)

    def _duty_cycle(self, wid: int, speed: float) -> None:
        """Run ``speed`` of every DUTY_PERIOD; freeze the rest."""
        pid = self.pids.get(wid)
        run_s = DUTY_PERIOD * speed
        idle_s = DUTY_PERIOD - run_s
        # deterministic phase: stagger workers so throttles don't beat
        phase = ((wid + self.seed) % 7) * (DUTY_PERIOD / 7.0)

        def cycle():
            self._stop_evt.wait(phase)
            self._record(wid, "throttle",
                         f"duty cycle speed={speed:g} "
                         f"period={DUTY_PERIOD:g}s")
            while not self._stop_evt.is_set():
                self._stop_evt.wait(run_s)
                # every signal under the lock, re-checking membership:
                # a hang_time SIGSTOP that lands between our waits must
                # never be undone by a throttle SIGCONT
                with self._lock:
                    if (self._stop_evt.is_set() or wid in self.killed
                            or wid in self.stopped):
                        return
                    if not _signal(pid, signal.SIGSTOP):
                        return
                self._stop_evt.wait(idle_s)
                with self._lock:
                    if wid in self.killed or wid in self.stopped:
                        return
                    if not _signal(pid, signal.SIGCONT):
                        return
        th = threading.Thread(target=cycle, daemon=True)
        self._threads.append(th)

    # ---------------------------------------------------------- lifecycle
    def start(self, t0: Optional[float] = None) -> None:
        self._t0 = time.monotonic() if t0 is None else t0
        for wid, w in enumerate(self.worker_specs):
            if wid not in self.pids:
                continue                       # dead-from-start: no process
            if w.fail_time is not None:
                self._at(w.fail_time, self.kill, wid)
            if w.hang_time is not None:
                self._at(w.hang_time, self._stop, wid)
            if w.speed < 1.0:
                self._duty_cycle(wid, max(w.speed, 1e-3))
        for th in self._threads:
            th.start()

    def stop(self) -> None:
        """Disarm timers and SIGCONT anything frozen (teardown must be
        able to reap every child — no zombies, no stopped orphans)."""
        self._stop_evt.set()
        for th in self._threads:
            th.join(timeout=2.0)
        for wid in list(self.stopped):
            pid = self.pids.get(wid)
            if pid is not None:
                _signal(pid, signal.SIGCONT)
        # belt-and-braces: a throttle thread may have been between
        # SIGSTOP and SIGCONT when stop() fired
        for wid, pid in self.pids.items():
            if wid not in self.killed:
                _signal(pid, signal.SIGCONT)
