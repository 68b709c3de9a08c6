"""Mid-run state capture for simulation-in-the-loop re-planning.

A snapshot is everything the adaptive layer may legitimately know about a
live engine run at one instant: the queue's task accounting (which tasks
are finished / in flight / still unscheduled), each worker's liveness *as
of that instant*, its configured perturbations, and the per-PE
measurements the DLS feedback loop has accumulated (``dls.PEStats``).

What a snapshot deliberately does NOT contain: future fail-stop instants.
The controller forecasts under the assumption that current conditions
persist — exactly the SimAS position (Mohammed & Ciorba 2021): simulate
the remainder under the observed state, not under an oracle's knowledge
of what will break next.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import dls, rdlb


@dataclasses.dataclass
class WorkerSnapshot:
    """One worker's state as known at capture time."""
    wid: int
    alive: bool
    speed: float                       # configured relative compute speed
    msg_latency: float                 # configured extra seconds/message
    tasks_done: int                    # executed so far (incl. wasted)
    observed_rate: float               # learned iterations/s (0 = no data)
    stats: Optional[dls.PEStats] = None  # copy of learned measurements


@dataclasses.dataclass
class EngineSnapshot:
    """Point-in-time capture of a live engine run.

    ``remaining`` is the forecast workload: every unfinished task, in id
    order.  Scheduled-but-unfinished tasks are included because the
    master cannot distinguish "in flight on a healthy worker" from "held
    by a failed one" — rDLB's whole premise.
    """
    t: float                           # capture instant (virtual s; wall
                                       # -clock s in threaded mode)
    n_tasks: int
    n_finished: int
    # Task-id sets are int arrays (``np.flatnonzero`` over the queue's
    # flag array — no O(N) Python list materialization at capture time;
    # a P=1024/N=10⁶ snapshot costs three vectorized passes).
    unscheduled: np.ndarray
    scheduled_unfinished: np.ndarray
    remaining: np.ndarray
    outstanding_duplicates: int        # live duplicate slots at capture
    technique: str                     # technique name driving the queue
    max_duplicates: Optional[int]
    barrier_max_duplicates: Optional[int]
    workers: list[WorkerSnapshot]
    rdlb_enabled: bool = True          # the queue's re-issue switch

    @property
    def n_remaining(self) -> int:
        return len(self.remaining)

    @property
    def n_alive(self) -> int:
        return sum(w.alive for w in self.workers)


def capture(engine, t: float = 0.0) -> EngineSnapshot:
    """Snapshot a live engine run at instant ``t``.

    Queue state — including per-PE technique stats — is copied under the
    queue lock (``snapshot_state``), so neither the flag array nor the
    learned measurements are seen mid-update.  Safe to call from any
    thread; worker liveness fields are read without a lock (single
    machine-word reads, and liveness is advisory for forecasting).
    """
    qs = engine.queue.snapshot_state()
    flags = np.frombuffer(qs["flags"], dtype=np.uint8)
    unscheduled = np.flatnonzero(flags == rdlb.Flag.UNSCHEDULED)
    in_flight = np.flatnonzero(flags == rdlb.Flag.SCHEDULED)
    stats = qs["stats"]
    workers = []
    for w in engine.workers:
        st = stats[w.wid] if w.wid < len(stats) else None
        workers.append(WorkerSnapshot(
            wid=w.wid,
            alive=w.alive_at(t) and not w.fails_by_count(),
            speed=w.speed,
            msg_latency=w.msg_latency,
            tasks_done=w.tasks_done,
            observed_rate=st.rate(False) if st is not None else 0.0,
            stats=st,
        ))
    return EngineSnapshot(
        t=t,
        n_tasks=len(flags),
        n_finished=qs["n_finished"],
        unscheduled=unscheduled,
        scheduled_unfinished=in_flight,
        remaining=np.flatnonzero(flags != rdlb.Flag.FINISHED),
        outstanding_duplicates=qs["outstanding_duplicates"],
        technique=qs["technique"],
        max_duplicates=qs["max_duplicates"],
        barrier_max_duplicates=qs["barrier_max_duplicates"],
        workers=workers,
        rdlb_enabled=qs.get("rdlb_enabled", True),
    )
