"""Discrete-event simulator of master-worker DLS execution (+- rDLB).

Faithfully reproduces the *timing* behaviour of the paper's MPI DLS4LB
experiments on this single-CPU container: P PEs self-schedule N tasks from
the central RobustQueue; the master (PE 0, which also computes, as in
DLS4LB) serializes scheduling transactions with overhead ``h``; failures
drop in-flight chunks; perturbations slow PEs or delay their messages.

The simulator is now a thin shell over the unified engine
(repro_torch.core.engine): its backend executes nothing — only nominal task
costs matter — and the engine's virtual-time event loop provides exact
causality (an rDLB duplicate is only issued if, at that instant, the
original chunk is still unfinished).  The SAME engine loop drives the
real executors (repro_torch.runtime), so simulated and executed schedules
cannot diverge: same (technique, scenario, seed) -> same assignment log.

Without rDLB and with a failure/hang, the execution never terminates —
reported as ``t_par = inf`` (the paper's "would wait indefinitely").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core import dls, engine, faults, rdlb


@dataclasses.dataclass
class SimResult:
    t_par: float                 # parallel loop execution time (inf = hang)
    n_finished: int
    n_tasks: int
    n_assignments: int
    n_duplicates: int
    wasted_tasks: int            # task executions whose result was discarded
    pe_busy: np.ndarray          # per-PE total compute seconds
    pe_idle: np.ndarray          # per-PE idle-before-termination seconds
    technique: str
    scenario: str
    rdlb: bool
    adaptive_decisions: list = dataclasses.field(default_factory=list)
                                 # DecisionRecords when an adaptive policy
                                 # watched the run (spec.adaptive.enabled)
    t_wall: float = 0.0          # wall-clock seconds (== t_par only in
                                 # threaded/process modes, where time IS
                                 # wall time)
    chaos_events: list = dataclasses.field(default_factory=list)
                                 # real OS actions (process mode)
    trace: object = None         # core.trace.Trace when the spec enabled
                                 # the flight recorder; None otherwise
    metrics: object = None       # MetricsHub.snapshot() dict when the spec
                                 # enabled live telemetry; None otherwise

    @property
    def hang(self) -> bool:
        return math.isinf(self.t_par)

    @property
    def wasted_fraction(self) -> float:
        return self.wasted_tasks / max(1, self.n_tasks)

    def to_dict(self, *, include_trace: bool = True) -> dict:
        """JSON-serializable run record (``python -m repro_torch run
        --emit-json``)."""

        def _rec(x):
            f = getattr(x, "to_dict", None)
            return f() if callable(f) else (
                dataclasses.asdict(x) if dataclasses.is_dataclass(x)
                and not isinstance(x, type) else repr(x))

        d = dict(
            t_par=None if math.isinf(self.t_par) else float(self.t_par),
            hang=self.hang,
            n_finished=int(self.n_finished),
            n_tasks=int(self.n_tasks),
            n_assignments=int(self.n_assignments),
            n_duplicates=int(self.n_duplicates),
            wasted_tasks=int(self.wasted_tasks),
            pe_busy=np.asarray(self.pe_busy).tolist(),
            pe_idle=np.asarray(self.pe_idle).tolist(),
            technique=self.technique,
            scenario=self.scenario,
            rdlb=bool(self.rdlb),
            t_wall=float(self.t_wall),
            adaptive_decisions=[_rec(x) for x in self.adaptive_decisions],
            chaos_events=[_rec(x) for x in self.chaos_events],
        )
        if include_trace and self.trace is not None:
            d["trace"] = self.trace.to_dict()
        if self.metrics is not None:
            d["metrics"] = self.metrics
        return d


class SimBackend(engine.WorkerBackend):
    """Timing-only backend: execution is a no-op; cost is the chunk's
    nominal task time (prefix sums over ``task_times``).

    ``ctime`` (the prefix-sum array, public) is the vectorized cost
    interface: the engine's fast-forward (repro_torch.core.fastpath) reads
    chunk costs for whole rounds straight from it instead of calling
    ``cost`` per chunk.
    """

    def __init__(self, task_times: np.ndarray) -> None:
        self.ctime = np.cumsum(np.concatenate([[0.0], task_times]))
        self._ctime = self.ctime               # back-compat alias

    def cost(self, chunk: rdlb.Chunk, wid: int) -> float:
        return float(self.ctime[chunk.stop] - self.ctime[chunk.start])


def workers_from_scenario(scenario: faults.Scenario
                          ) -> list[engine.EngineWorker]:
    """Map a paper scenario (Table 1) onto engine worker liveness —
    routed through the one perturbation vocabulary (ClusterSpec)."""
    from repro_torch.api.spec import ClusterSpec
    return ClusterSpec.from_scenario(scenario).engine_workers()


_UNSET = object()


def spec_from_legacy(technique_name: str, scenario: faults.Scenario, *,
                     rdlb_enabled: bool = True, seed: int = 0,
                     h: float = 1e-4,
                     max_duplicates: Optional[int] = None,
                     barrier_max_duplicates: Optional[int] = 1,
                     horizon: float = 1e7):
    """The legacy simulator keyword vocabulary as one RunSpec."""
    from repro_torch import api
    return api.RunSpec(
        scheduling=api.SchedulingSpec(technique=technique_name, seed=seed),
        robustness=api.RobustnessSpec(
            rdlb_enabled=rdlb_enabled, max_duplicates=max_duplicates,
            barrier_max_duplicates=barrier_max_duplicates),
        cluster=api.ClusterSpec.from_scenario(scenario),
        execution=api.ExecutionSpec(h=h, horizon=horizon))


def simulate(task_times: np.ndarray,
             technique: Optional[dls.Technique] = None,
             scenario: Optional[faults.Scenario] = None,
             *,
             spec=None,
             rdlb_enabled=_UNSET,
             h=_UNSET,
             max_duplicates=_UNSET,
             barrier_max_duplicates=_UNSET,
             horizon=_UNSET,
             queue_cls: type = rdlb.RobustQueue,
             backend: Optional[engine.WorkerBackend] = None,
             adaptive=None) -> SimResult:
    """Run one DLS execution and return its timing/robustness metrics.

    New form: ``simulate(task_times, spec=run_spec)`` — everything about
    the run comes from the declarative :class:`repro_torch.api.RunSpec`
    (equivalent to ``repro_torch.api.simulate(spec, task_times)``).

    Legacy form (deprecated): pass a prebuilt ``technique`` object, a
    ``faults.Scenario``, and the keyword knobs.  The shim constructs the
    equivalent spec — runs are identical event-for-event — and emits a
    ``DeprecationWarning``.

    task_times[i]: nominal execution time of task i on an unperturbed PE.
    queue_cls:     RobustQueue subclass (custom queue wiring).
    backend:       override the timing-only backend — inject a
                   real-executing backend (e.g. runtime.backends.FnBackend
                   over the same costs) to EXECUTE the schedule the
                   simulator would produce, event for event.
    adaptive:      optional adaptive policy (repro.adaptive): snapshots
                   the run at decision points and hot-swaps the
                   technique/rDLB knobs for the remainder.
    """
    from repro_torch import api
    legacy = {k: v for k, v in dict(
        rdlb_enabled=rdlb_enabled, h=h, max_duplicates=max_duplicates,
        barrier_max_duplicates=barrier_max_duplicates,
        horizon=horizon).items() if v is not _UNSET}
    if spec is not None:
        if technique is not None or scenario is not None or legacy:
            raise TypeError("simulate(spec=...) takes no legacy "
                            "technique/scenario/keyword arguments")
        return api.simulate(spec, task_times, backend=backend,
                            adaptive=adaptive, queue_cls=queue_cls)
    if technique is None or scenario is None:
        raise TypeError("simulate() needs either spec= or "
                        "(technique, scenario)")
    api.warn_legacy("simulator.simulate(task_times, technique, scenario, "
                    "...)")
    try:
        spec = spec_from_legacy(technique.name, scenario, **legacy)
    except ValueError:
        # A custom Technique subclass whose name is not a registered DLS
        # technique: the prebuilt object drives the run either way; the
        # spec just carries a placeholder name.
        spec = spec_from_legacy("FAC", scenario, **legacy)
    return api.simulate(spec, task_times, technique=technique,
                        backend=backend, adaptive=adaptive,
                        queue_cls=queue_cls)


def run(task_times: np.ndarray, technique_name: str,
        scenario: faults.Scenario, *, rdlb_enabled: bool = True,
        h: float = 1e-4, seed: int = 0,
        max_duplicates: Optional[int] = None) -> SimResult:
    """Entry point: builds the technique by name.

    A thin convenience over the spec API: constructs the equivalent
    RunSpec and calls ``repro_torch.api.simulate`` (no deprecation — this IS
    the spec vocabulary, spelled as a function call).
    """
    from repro_torch import api
    spec = spec_from_legacy(technique_name, scenario,
                            rdlb_enabled=rdlb_enabled, seed=seed, h=h,
                            max_duplicates=max_duplicates)
    return api.simulate(spec, task_times)


# API-compat alias: the adaptive path no longer differs from run().
simulate_adaptive = run
