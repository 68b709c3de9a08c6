"""Declarative, serializable run specifications — scenarios as DATA.

The paper's point is that rDLB is ONE mechanism robustifying any DLS
execution; PR 1/2 made that literal with one engine.  This module makes
the *API* tell the same story: every driver (discrete-event simulator,
training executor, serving executor, the adaptive forecaster's candidate
sweep, the benchmarks, the ``python -m repro_torch`` CLI) is configured by the
same frozen, composable :class:`RunSpec`:

    RunSpec
      ├── SchedulingSpec   which DLS technique sizes chunks (+ its params)
      ├── RobustnessSpec   the rDLB knobs (re-issue on/off, duplicate caps)
      ├── ClusterSpec      the workers and their perturbations — the ONE
      │                    perturbation vocabulary: ``faults.Scenario``,
      │                    executor ``FaultPlan``s and serve-side
      │                    dead/slow sets all map onto it, and it is the
      │                    only constructor of ``EngineWorker`` lists
      ├── ExecutionSpec    virtual-time vs threaded, h, horizon, polling
      └── AdaptiveSpec     simulate-in-the-loop re-planning cadence/knobs

Specs are immutable (functional ``replace``/``override`` updates), fully
hashable, and round-trip losslessly through ``to_dict``/``from_dict`` and
JSON — a scenario is a diffable file, not a constructor argument sprawl.

:class:`Candidate` is a spec *delta*: the adaptive portfolio sweep
applies each candidate to the incumbent spec, so a portfolio may explore
ANY spec field (via dotted-path ``overrides``), not just technique and
duplicate caps.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable, Mapping, Optional, Sequence

from repro_torch.core import dls, engine

SPEC_VERSION = 1

__all__ = [
    "SPEC_VERSION", "VALID_MODES", "SchedulingSpec", "RobustnessSpec",
    "WorkerSpec", "ClusterSpec", "ExecutionSpec", "AdaptiveSpec",
    "Candidate", "DEFAULT_PORTFOLIO", "DEVICE_PORTFOLIO", "RunSpec",
    "spec_override",
]


def _pairs(value: Any) -> tuple:
    """Normalize a mapping / iterable of pairs / JSON list-of-lists into a
    canonical hashable tuple of (key, value) pairs."""
    if value is None:
        return ()
    if isinstance(value, Mapping):
        items = value.items()
    else:
        items = [tuple(p) for p in value]
    return tuple((str(k), _hashable(v)) for k, v in items)


def _hashable(v: Any) -> Any:
    """JSON deserialization yields lists where specs carry tuples."""
    if isinstance(v, list):
        return tuple(_hashable(x) for x in v)
    return v


# --------------------------------------------------------------- scheduling
@dataclasses.dataclass(frozen=True)
class SchedulingSpec:
    """Which DLS technique sizes chunks, and how it is parameterized.

    ``params`` are extra keyword arguments for the technique model
    (``dls.make_technique``), e.g. ``(("h", 1e-3), ("sigma", 2.0))`` for
    FSC's overhead/variance estimates or ``weights`` for WF — kept as a
    tuple of (name, value) pairs so the spec stays hashable and
    JSON-round-trippable.  ``feedback`` controls whether completed-chunk
    measurements are fed back to the technique (the AWF-*/AF loop).
    """
    technique: str = "FAC"
    seed: int = 0
    feedback: bool = True
    params: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "params", _pairs(self.params))
        if self.technique not in dls.ALL_TECHNIQUES:
            raise ValueError(
                f"unknown DLS technique {self.technique!r}; "
                f"choose from {dls.ALL_TECHNIQUES}")

    def param_dict(self) -> dict:
        return dict(self.params)

    @classmethod
    def from_dict(cls, d: Mapping) -> "SchedulingSpec":
        return cls(technique=d.get("technique", "FAC"),
                   seed=int(d.get("seed", 0)),
                   feedback=bool(d.get("feedback", True)),
                   params=_pairs(d.get("params")))


# --------------------------------------------------------------- robustness
@dataclasses.dataclass(frozen=True)
class RobustnessSpec:
    """The rDLB knobs.

    ``rdlb_enabled=False`` is the paper's non-robust DLS4LB (hangs on a
    failure); ``max_duplicates`` caps concurrent duplicates per original
    chunk; ``barrier_max_duplicates`` is the batch-weight barrier damping
    cap (None = uncapped re-issue during AWF-B/D weight collection).
    """
    rdlb_enabled: bool = True
    max_duplicates: Optional[int] = None
    barrier_max_duplicates: Optional[int] = 1

    @classmethod
    def from_dict(cls, d: Mapping) -> "RobustnessSpec":
        return cls(rdlb_enabled=bool(d.get("rdlb_enabled", True)),
                   max_duplicates=d.get("max_duplicates"),
                   barrier_max_duplicates=d.get("barrier_max_duplicates", 1))


# ------------------------------------------------------------------ cluster
@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """One worker's perturbation profile — THE unified vocabulary.

    Absorbs all three legacy spellings: ``faults.PEProfile`` (speed /
    msg_latency / fail_time), executor ``FaultPlan`` entries (speed /
    fail_after_tasks), and serve-side dead/slow sets (alive /
    sleep_per_task).  ``sleep_per_task`` only matters in threaded mode
    (an injected wall-clock delay); virtual time uses ``speed``.

    ``hang_time`` is a FREEZE instant (paper Fig. 1b): from the
    scheduler's point of view it is indistinguishable from a fail-stop
    (the worker never reports again), so virtual/threaded modes fold it
    into ``fail_time``; the process-cluster runtime compiles it to a
    real SIGSTOP (the process survives, frozen) where ``fail_time``
    compiles to SIGKILL.
    """
    speed: float = 1.0
    msg_latency: float = 0.0
    fail_time: Optional[float] = None
    fail_after_tasks: Optional[int] = None
    sleep_per_task: float = 0.0
    alive: bool = True
    hang_time: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Mapping) -> "WorkerSpec":
        return cls(speed=float(d.get("speed", 1.0)),
                   msg_latency=float(d.get("msg_latency", 0.0)),
                   fail_time=d.get("fail_time"),
                   fail_after_tasks=d.get("fail_after_tasks"),
                   sleep_per_task=float(d.get("sleep_per_task", 0.0)),
                   alive=bool(d.get("alive", True)),
                   hang_time=d.get("hang_time"))


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Worker count + per-worker perturbations.

    ``workers`` is either empty (all ``n_workers`` nominal) or exactly
    ``n_workers`` :class:`WorkerSpec` entries.  This class is the ONLY
    path that constructs :class:`repro_torch.core.engine.EngineWorker` lists —
    every driver's perturbation wiring goes through it.
    """
    n_workers: int = 1
    workers: tuple = ()
    name: str = ""

    def __post_init__(self):
        workers = tuple(
            w if isinstance(w, WorkerSpec) else WorkerSpec.from_dict(w)
            for w in self.workers)
        object.__setattr__(self, "workers", workers)
        if self.n_workers <= 0:
            raise ValueError(f"need n_workers > 0, got {self.n_workers}")
        if workers and len(workers) != self.n_workers:
            raise ValueError(f"got {len(workers)} worker specs for "
                             f"n_workers={self.n_workers}")

    # ------------------------------------------------------- constructors
    @classmethod
    def uniform(cls, n_workers: int, name: str = "") -> "ClusterSpec":
        return cls(n_workers=n_workers, name=name)

    @classmethod
    def from_scenario(cls, scenario) -> "ClusterSpec":
        """Absorb a ``faults.Scenario`` (paper Table-1 vocabulary)."""
        return cls(
            n_workers=scenario.P, name=scenario.name,
            workers=tuple(WorkerSpec(speed=p.speed,
                                     msg_latency=p.msg_latency,
                                     fail_time=p.fail_time)
                          for p in scenario.profiles))

    @classmethod
    def from_fault_plan(cls, n_workers: int, plan=None,
                        name: str = "fault_plan") -> "ClusterSpec":
        """Absorb a training-executor ``FaultPlan`` (fail_after / slow)."""
        fail_after = dict(getattr(plan, "fail_after", None) or {})
        slow = dict(getattr(plan, "slow", None) or {})
        return cls(
            n_workers=n_workers, name=name,
            workers=tuple(WorkerSpec(speed=slow.get(w, 1.0),
                                     fail_after_tasks=fail_after.get(w))
                          for w in range(n_workers)))

    @classmethod
    def from_worker_states(cls, states: Sequence,
                           name: str = "train") -> "ClusterSpec":
        """Absorb the executor's live ``WorkerState`` list: liveness and
        learned speed overlay each worker's originating spec profile, so
        spec-declared perturbations the live fields don't track
        (fail_time, msg_latency, sleep_per_task) survive into the next
        step's cluster."""
        out = []
        for s in states:
            base = getattr(s, "profile", None) or WorkerSpec()
            out.append(dataclasses.replace(
                base, speed=s.speed, alive=s.alive,
                fail_after_tasks=s.fail_after_tasks))
        return cls(n_workers=len(states), name=name, workers=tuple(out))

    @classmethod
    def from_serve(cls, n_workers: int, *, dead: Iterable[int] = (),
                   slow: Optional[Mapping[int, float]] = None,
                   fail_at: Optional[Mapping[int, int]] = None,
                   name: str = "serve") -> "ClusterSpec":
        """Absorb the serve executor's dead/slow/fail_at vocabulary."""
        return cls.uniform(n_workers, name=name).with_serve_state(
            dead=dead, slow=slow, fail_at=fail_at)

    def with_serve_state(self, *, dead: Iterable[int] = (),
                         slow: Optional[Mapping[int, float]] = None,
                         fail_at: Optional[Mapping[int, int]] = None,
                         speed_compose: bool = True) -> "ClusterSpec":
        """Overlay serve-side perturbations on this cluster.

        ``slow[wid]`` is EXTRA seconds per unit-cost request: it maps to
        an additional ``sleep_per_task`` in threaded mode and to the
        equivalent virtual-time slowdown COMPOSED with the worker's
        declared speed — ``1/(1/speed + extra)`` (for a nominal worker,
        the classic ``1/(1+extra)``); slowing an already-slow worker can
        only make it slower.

        ``speed_compose=False`` skips the speed composition and carries
        the slowdown ONLY as ``sleep_per_task``: required for process
        mode, where BOTH fields are physically realized (``speed<1``
        becomes a SIGSTOP/SIGCONT duty cycle, ``sleep_per_task`` a real
        sleep) — composing into both would apply one declared
        perturbation twice.
        """
        dead = set(dead)
        slow = dict(slow or {})
        fail_at = dict(fail_at or {})
        out = []
        for wid, w in enumerate(self.worker_specs()):
            extra = slow.get(wid)
            out.append(dataclasses.replace(
                w,
                alive=w.alive and wid not in dead,
                fail_after_tasks=fail_at.get(wid, w.fail_after_tasks),
                speed=(w.speed if extra is None or not speed_compose
                       else 1.0 / (1.0 / w.speed + extra)),
                sleep_per_task=(w.sleep_per_task if extra is None
                                else w.sleep_per_task + extra)))
        return dataclasses.replace(self, workers=tuple(out))

    # ------------------------------------------------------------ queries
    def worker_specs(self) -> tuple:
        """Per-worker specs, with the empty shorthand resolved."""
        return self.workers or tuple(WorkerSpec()
                                     for _ in range(self.n_workers))

    def engine_workers(self) -> list:
        """THE EngineWorker factory (the single perturbation seam).

        ``hang_time`` folds into ``fail_time`` here: to the master a
        frozen worker and a dead one are the same event (it never
        reports again); only the process runtime distinguishes them
        physically (SIGSTOP vs SIGKILL — repro.cluster.chaos).
        """
        def _stop_at(w):
            ts = [t for t in (w.fail_time, w.hang_time) if t is not None]
            return min(ts) if ts else None
        return [engine.EngineWorker(wid, speed=w.speed,
                                    msg_latency=w.msg_latency,
                                    fail_time=_stop_at(w),
                                    fail_after_tasks=w.fail_after_tasks,
                                    sleep_per_task=w.sleep_per_task,
                                    alive=w.alive)
                for wid, w in enumerate(self.worker_specs())]

    @classmethod
    def from_dict(cls, d: Mapping) -> "ClusterSpec":
        return cls(n_workers=int(d.get("n_workers", 1)),
                   workers=tuple(WorkerSpec.from_dict(w)
                                 for w in d.get("workers", ())),
                   name=d.get("name", ""))


# ---------------------------------------------------------------- execution
VALID_MODES = ("virtual", "threaded", "process")


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """How the engine runs the schedule.

    ``mode="virtual"`` is the deterministic virtual-time event loop
    (``Engine.run``); ``"threaded"`` is one OS thread per worker
    (``Engine.run_threaded`` — duplicates race in wall-clock time);
    ``"process"`` is one real OS process per worker speaking the
    request/report protocol over a socket to an in-process master
    (``repro.cluster`` — perturbations become real signals: SIGKILL,
    SIGSTOP, duty-cycle throttling).
    ``h`` is the master's per-transaction overhead in virtual seconds;
    ``horizon`` bounds virtual time (exceeding it reports a hang);
    ``poll``/``stall_timeout``/``max_fruitless_polls`` are the polling
    knobs shared by threaded and process modes (``stall_timeout``:
    seconds without global queue progress before the run is declared
    hung; ``max_fruitless_polls``: consecutive no-progress polls before
    the same verdict).
    ``n_groups > 1`` enables the two-level hierarchy in process mode:
    group masters each own a contiguous worker subset; the top-level
    queue schedules group-sized chunks and rDLB re-issues them ACROSS
    groups.  ``wall_timeout`` is a process-mode hard wall-clock cap
    (None = rely on stall detection only).
    ``trace`` turns on the flight recorder (``repro_torch.core.trace``): the
    run's event stream lands on ``EngineStats.trace`` /
    ``SimResult.trace``.  Off by default — an untraced run pays nothing.
    ``metrics`` turns on live telemetry (``repro.obs.MetricsHub``): the
    recorder streams every event through online estimators and the
    summary lands on ``EngineStats.metrics`` / ``SimResult.metrics``.
    Works with or without ``trace`` — metrics alone runs the recorder
    store-less (no rows retained), so long runs can be metered without
    holding a trace in memory.  Same zero-cost-when-off contract.
    """
    mode: str = "virtual"
    h: float = 1e-4
    horizon: float = 1e7
    poll: float = 1e-3
    stall_timeout: float = 5.0
    max_fruitless_polls: Optional[int] = None
    n_groups: int = 1
    wall_timeout: Optional[float] = None
    trace: bool = False
    metrics: bool = False

    def __post_init__(self):
        if self.mode not in VALID_MODES:
            raise ValueError(
                f"mode must be one of {VALID_MODES}, got {self.mode!r}")
        if self.n_groups < 1:
            raise ValueError(f"need n_groups >= 1, got {self.n_groups}")
        if self.n_groups > 1 and self.mode != "process":
            # the virtual/threaded engines have no group-master tier; a
            # silently single-level schedule would invalidate any
            # twin-prediction comparison against the process run
            raise ValueError(
                f"n_groups={self.n_groups} requires mode='process' "
                f"(the two-level hierarchy only exists in the cluster "
                f"runtime), got mode={self.mode!r}")

    @classmethod
    def from_dict(cls, d: Mapping) -> "ExecutionSpec":
        return cls(mode=d.get("mode", "virtual"),
                   h=float(d.get("h", 1e-4)),
                   horizon=float(d.get("horizon", 1e7)),
                   poll=float(d.get("poll", 1e-3)),
                   stall_timeout=float(d.get("stall_timeout", 5.0)),
                   max_fruitless_polls=d.get("max_fruitless_polls"),
                   n_groups=int(d.get("n_groups", 1)),
                   wall_timeout=d.get("wall_timeout"),
                   trace=bool(d.get("trace", False)),
                   metrics=bool(d.get("metrics", False)))


# ---------------------------------------------------------------- candidate
KEEP = "keep"   # field sentinel: leave the incumbent's value unchanged
                # (a plain string so Candidates stay JSON-round-trippable)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """A spec DELTA: one adaptive-portfolio entry.

    Every field defaults to "keep the incumbent's value".  Applied to an
    incumbent :class:`RunSpec`, it (1) replaces the technique when
    ``technique`` is not None, (2) sets whichever rDLB duplicate knobs
    are not :data:`KEEP`, and (3) applies arbitrary dotted-path
    ``overrides`` — so a portfolio can explore ANY spec field (e.g.
    ``(("execution.h", 5e-3),)`` or ``(("robustness.rdlb_enabled",
    False),)``), not only technique × dup-knobs.
    """
    technique: Optional[str] = None
    max_duplicates: Any = KEEP          # int, None (uncapped), or KEEP
    barrier_max_duplicates: Any = KEEP  # int, None (uncapped), or KEEP
    overrides: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "overrides", _pairs(self.overrides))

    def apply(self, spec: "RunSpec") -> "RunSpec":
        """Incumbent spec -> candidate spec (KEEP fields untouched)."""
        sched = spec.scheduling
        if self.technique is not None:
            sched = dataclasses.replace(sched, technique=self.technique)
        rob = spec.robustness
        if self.max_duplicates != KEEP:
            rob = dataclasses.replace(rob,
                                      max_duplicates=self.max_duplicates)
        if self.barrier_max_duplicates != KEEP:
            rob = dataclasses.replace(
                rob, barrier_max_duplicates=self.barrier_max_duplicates)
        out = dataclasses.replace(spec, scheduling=sched, robustness=rob)
        for path, value in self.overrides:
            out = spec_override(out, path, value)
        return out

    @property
    def label(self) -> str:
        parts = [self.technique if self.technique is not None else "*"]
        if self.max_duplicates != KEEP and self.max_duplicates is not None:
            parts.append(f"dup{self.max_duplicates}")
        if self.barrier_max_duplicates != KEEP:
            b = ("inf" if self.barrier_max_duplicates is None
                 else str(self.barrier_max_duplicates))
            if b != "1":
                parts.append(f"bdup{b}")
        parts += [f"{p}={v}" for p, v in self.overrides]
        return "+".join(parts)

    @classmethod
    def from_dict(cls, d: Mapping) -> "Candidate":
        return cls(technique=d.get("technique"),
                   max_duplicates=d.get("max_duplicates", KEEP),
                   barrier_max_duplicates=d.get("barrier_max_duplicates",
                                                KEEP),
                   overrides=_pairs(d.get("overrides")))


DEFAULT_PORTFOLIO: tuple = (
    Candidate("FAC"),
    Candidate("GSS"),
    Candidate("mFSC"),
    Candidate("AWF-C"),
    Candidate("AF"),
    Candidate("FAC", max_duplicates=2),
    Candidate("AWF-B", barrier_max_duplicates=None),
)

# Fixed-chunk candidates that lower onto the batched device simulator
# (core.devicesim): with ``AdaptiveSpec(device_sweep=True)`` the whole
# portfolio forecasts in ONE jit/vmap call.  Any candidate outside the
# device regime simply falls back to the scalar engine, so mixing these
# with DEFAULT_PORTFOLIO entries is safe — just slower.
DEVICE_PORTFOLIO: tuple = (
    Candidate("SS"),
    Candidate("STATIC"),
    Candidate("mFSC"),
    Candidate("FSC"),
)


# ----------------------------------------------------------------- adaptive
@dataclasses.dataclass(frozen=True)
class AdaptiveSpec:
    """Simulation-in-the-loop re-planning policy (repro.adaptive).

    ``enabled=False`` (default) runs the spec statically.  An empty
    ``portfolio`` means :data:`DEFAULT_PORTFOLIO`.  Field semantics match
    ``repro.adaptive.AdaptiveConfig``.

    ``calibrate=True`` makes every portfolio sweep forecast from the
    *calibrated* cluster state instead of the declared one: per-worker
    measured speeds (from the engine's own PEStats) replace snapshot
    speeds, and an EWMA drift detector (``drift_threshold``,
    ``drift_alpha``) re-calibrates when measured conditions diverge from
    the speeds the forecaster is currently using — each decision's
    DecisionRecord carries the calibration evidence.
    """
    enabled: bool = False
    portfolio: tuple = ()
    decision_every_chunks: Optional[int] = 64
    decision_every_time: Optional[float] = None
    plan_at_start: bool = True
    max_decisions: int = 8
    min_remaining: int = 64
    hysteresis: float = 0.05
    max_sim_tasks: Optional[int] = 2048
    prewarm: bool = True
    forecast_h: Optional[float] = None
    seed: int = 0
    device_sweep: bool = False
    calibrate: bool = False
    drift_threshold: float = 0.15
    drift_alpha: float = 0.5

    def __post_init__(self):
        object.__setattr__(self, "portfolio", tuple(
            c if isinstance(c, Candidate) else Candidate.from_dict(c)
            for c in self.portfolio))

    def to_config(self):
        """Build the matching ``repro.adaptive.AdaptiveConfig``: not ported
        to repro_torch yet (ROADMAP.md queue A, item A9)."""
        raise NotImplementedError(
            "repro.adaptive.AdaptiveConfig is not ported to repro_torch "
            "yet: ROADMAP.md queue A, item A9")

    @classmethod
    def from_dict(cls, d: Mapping) -> "AdaptiveSpec":
        kw = {f.name: d[f.name] for f in dataclasses.fields(cls)
              if f.name in d}
        kw["portfolio"] = tuple(Candidate.from_dict(c)
                                for c in d.get("portfolio", ()))
        return cls(**kw)


# ------------------------------------------------------------------ RunSpec
def spec_override(spec, path: str, value: Any):
    """Functional dotted-path update: ``spec_override(s, "execution.h",
    1e-3)`` returns a new spec with that one field replaced."""
    head, _, rest = path.partition(".")
    if not hasattr(spec, head):
        raise AttributeError(
            f"{type(spec).__name__} has no spec field {head!r} "
            f"(while overriding {path!r})")
    new = (spec_override(getattr(spec, head), rest, value) if rest
           else _hashable(value))
    return dataclasses.replace(spec, **{head: new})


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One complete, serializable description of a DLS+rDLB run.

    ``n_tasks`` may stay None when the workload defines it (the
    simulator's ``len(task_times)``, the serve executor's request count);
    the training executor requires it (microbatches per step).
    """
    scheduling: SchedulingSpec = SchedulingSpec()
    robustness: RobustnessSpec = RobustnessSpec()
    cluster: ClusterSpec = ClusterSpec()
    execution: ExecutionSpec = ExecutionSpec()
    adaptive: AdaptiveSpec = AdaptiveSpec()
    n_tasks: Optional[int] = None
    name: str = ""

    # ---------------------------------------------------------- functional
    def replace(self, **changes) -> "RunSpec":
        return dataclasses.replace(self, **changes)

    def override(self, path: str, value: Any) -> "RunSpec":
        """Dotted-path single-field update (see :func:`spec_override`)."""
        return spec_override(self, path, value)

    def overriding(self, overrides: Mapping[str, Any]) -> "RunSpec":
        out = self
        for path, value in overrides.items():
            out = spec_override(out, path, value)
        return out

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["version"] = SPEC_VERSION
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "RunSpec":
        version = d.get("version", SPEC_VERSION)
        if version > SPEC_VERSION:
            raise ValueError(f"spec version {version} is newer than "
                             f"supported {SPEC_VERSION}")
        return cls(
            scheduling=SchedulingSpec.from_dict(d.get("scheduling", {})),
            robustness=RobustnessSpec.from_dict(d.get("robustness", {})),
            cluster=ClusterSpec.from_dict(d.get("cluster", {})),
            execution=ExecutionSpec.from_dict(d.get("execution", {})),
            adaptive=AdaptiveSpec.from_dict(d.get("adaptive", {})),
            n_tasks=d.get("n_tasks"),
            name=d.get("name", ""))

    def to_json(self, *, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "RunSpec":
        return cls.from_dict(json.loads(text))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "RunSpec":
        with open(path) as f:
            return cls.from_json(f.read())
