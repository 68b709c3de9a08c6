"""The one-call facade: RunSpec -> configured queue + workers + engine.

Every driver funnels through :func:`build`:

  * ``repro_torch.core.simulator.simulate``/``run`` (timing-only backend),
  * ``repro_torch.runtime.FnBackend`` runs (the apps' real tasks); the
    training and serving executors come with their slices,
  * the adaptive forecaster's candidate sweep (resumed remainders),
  * benchmarks and the ``python -m repro_torch`` CLI.

``simulate(spec, task_times)`` is the scenario-as-data entry point: the
full discrete-event simulation of one spec over one workload.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional, Sequence

import numpy as np

from repro_torch.api.spec import (ClusterSpec, ExecutionSpec, RobustnessSpec,
                            RunSpec, SchedulingSpec)
from repro_torch.core import dls, engine, rdlb
from repro_torch.core import simulator as _sim

__all__ = ["build", "run", "execute", "simulate", "make_scheduler",
           "train_spec", "serve_spec", "warn_legacy", "LEGACY_MSG"]

LEGACY_MSG = "legacy keyword API; build a repro_torch.api.RunSpec instead"


def warn_legacy(what: str, *, stacklevel: int = 3) -> None:
    """One shared DeprecationWarning for every legacy-kwarg shim."""
    warnings.warn(f"{LEGACY_MSG} ({what})", DeprecationWarning,
                  stacklevel=stacklevel)


def train_spec(*, technique: str = "FAC", n_workers: int = 4,
               n_tasks: int = 8, rdlb_enabled: bool = True,
               max_duplicates: Optional[int] = None,
               threaded: bool = False, name: str = "train") -> RunSpec:
    """Executor-flavored RunSpec: unit-cost microbatch tasks, no master
    overhead (h=0), round-count horizon — the defaults every training
    driver shares.  Refine with ``.replace()``/``.override()``."""
    return RunSpec(
        scheduling=SchedulingSpec(technique=technique),
        robustness=RobustnessSpec(rdlb_enabled=rdlb_enabled,
                                  max_duplicates=max_duplicates),
        cluster=ClusterSpec(n_workers=n_workers, name=name),
        execution=ExecutionSpec(mode="threaded" if threaded else "virtual",
                                h=0.0, horizon=100000.0),
        n_tasks=n_tasks)


def serve_spec(*, technique: str = "SS", n_workers: int = 2,
               rdlb_enabled: bool = True,
               max_duplicates: Optional[int] = None,
               threaded: bool = False, name: str = "serve") -> RunSpec:
    """Serve-flavored RunSpec: unit-cost request tasks, h=0, round-count
    horizon (n_tasks stays None — the request batch defines it)."""
    return RunSpec(
        scheduling=SchedulingSpec(technique=technique),
        robustness=RobustnessSpec(rdlb_enabled=rdlb_enabled,
                                  max_duplicates=max_duplicates),
        cluster=ClusterSpec(n_workers=n_workers, name=name),
        execution=ExecutionSpec(mode="threaded" if threaded else "virtual",
                                h=0.0, horizon=100000.0))


def make_scheduler(spec: RunSpec, n_tasks: int, *,
                   n_workers: Optional[int] = None) -> dls.Technique:
    """Build the spec's DLS technique, sized for ``n_tasks`` over the
    spec's cluster (or an explicit ``n_workers`` override — the
    two-level cluster mode sizes the TOP technique for its group
    masters instead of the full worker set)."""
    s = spec.scheduling
    P = n_workers if n_workers is not None else spec.cluster.n_workers
    return dls.make_technique(s.technique, max(1, int(n_tasks)), P,
                              seed=s.seed, **s.param_dict())


def build(spec: RunSpec, backend: engine.WorkerBackend, *,
          n_tasks: Optional[int] = None,
          technique: Optional[dls.Technique] = None,
          adaptive: Any = None,
          task_times: Optional[Sequence[float]] = None,
          queue_cls: type = rdlb.RobustQueue,
          factory: Any = None,
          sim_device: Any = None):
    """RunSpec -> ready-to-run driver (with its queue and workers).

    ``mode="virtual"``/``"threaded"`` build a ``repro_torch.core.engine.Engine``;
    ``mode="process"`` raises ``NotImplementedError`` until its module is
    ported (ROADMAP.md queue A, item A8).

    ``technique`` injects a prebuilt (e.g. pre-warmed) technique instead
    of constructing one from the spec; ``adaptive`` injects a live
    policy object, overriding ``spec.adaptive``; ``task_times`` seeds
    the spec-built adaptive controller's forecast workload (None =
    unit-cost tasks); ``sim_device`` is the torch device of that
    controller's ``device_sweep`` forecasts (None = the card);
    ``factory`` is the process-mode child-side runner, kept in the
    signature for parity with ``repro.api.build``.
    """
    N = n_tasks if n_tasks is not None else spec.n_tasks
    if N is None:
        raise ValueError("spec.n_tasks is unset and no n_tasks was given")
    e = spec.execution
    if technique is not None:
        tech = technique
    else:
        # two-level: the TOP queue schedules group-sized chunks, so the
        # technique is sized for n_groups super-workers (group masters)
        tech = make_scheduler(
            spec, N, n_workers=(e.n_groups if e.mode == "process"
                                and e.n_groups > 1 else None))
    r = spec.robustness
    queue = queue_cls(int(N), tech, rdlb_enabled=r.rdlb_enabled,
                      max_duplicates=r.max_duplicates,
                      barrier_max_duplicates=r.barrier_max_duplicates)
    policy = adaptive
    if policy is None and spec.adaptive.enabled:
        from repro_torch.adaptive import AdaptiveController  # lazy: no cycle
        policy = AdaptiveController(task_times=task_times,
                                    config=spec.adaptive.to_config(),
                                    sim_device=sim_device)
    recorder = None
    if e.trace or e.metrics:
        from repro_torch.core import trace as _trc            # lazy import
        hub = None
        if e.metrics:
            from repro_torch.obs import MetricsHub            # lazy import
            hub = MetricsHub(n_workers=spec.cluster.n_workers)
        # metrics without trace: the recorder runs store-less — events
        # stream through the hub but no rows are kept
        recorder = _trc.TraceRecorder(hub=hub, store=e.trace)
    if e.mode == "process":
        raise NotImplementedError(
            "mode='process' (repro.cluster) is not ported to repro_torch "
            "yet: ROADMAP.md queue A, item A8")
    return engine.Engine(queue, spec.cluster.engine_workers(), backend,
                         h=e.h, horizon=e.horizon,
                         record_feedback=spec.scheduling.feedback,
                         max_fruitless_polls=e.max_fruitless_polls,
                         adaptive=policy, trace=recorder)


def run(spec: RunSpec, eng) -> engine.EngineStats:
    """Run a built driver in the spec's execution mode."""
    e = spec.execution
    if e.mode == "threaded":
        return eng.run_threaded(poll=e.poll, stall_timeout=e.stall_timeout)
    return eng.run()       # virtual Engine.run() or ClusterRun.run()


def execute(spec: RunSpec, backend: engine.WorkerBackend,
            **build_kw) -> engine.EngineStats:
    """build + run in one call."""
    return run(spec, build(spec, backend, **build_kw))


def simulate(spec: RunSpec, task_times: Sequence[float], *,
             backend: Optional[engine.WorkerBackend] = None,
             technique: Optional[dls.Technique] = None,
             adaptive: Any = None,
             queue_cls: type = rdlb.RobustQueue,
             sim_device: Any = None) -> "_sim.SimResult":
    """Discrete-event simulation of one RunSpec over ``task_times``.

    The scenario-as-data entry point: everything about the run —
    technique, rDLB knobs, worker perturbations, execution mode,
    adaptive policy — comes from the spec; the workload is the nominal
    per-task times.  ``sim_device`` places a spec-built adaptive
    policy's ``device_sweep`` forecasts (None = the card).  Returns the
    same :class:`SimResult` as the legacy ``simulator.simulate``.
    """
    tt = np.asarray(task_times, dtype=float)
    N = len(tt)
    if spec.n_tasks is not None and spec.n_tasks != N:
        raise ValueError(f"spec.n_tasks={spec.n_tasks} but task_times "
                         f"has {N} entries")
    eng = build(spec, backend or _sim.SimBackend(tt), n_tasks=N,
                technique=technique, adaptive=adaptive, task_times=tt,
                queue_cls=queue_cls, sim_device=sim_device)
    tech_name = eng.queue.technique.name   # adaptive may hot-swap mid-run
    st = run(spec, eng)
    return _sim.SimResult(
        t_par=st.t_virtual,
        n_finished=st.n_finished,
        n_tasks=N,
        n_assignments=st.n_assignments,
        n_duplicates=st.n_duplicates,
        wasted_tasks=st.wasted_tasks,
        pe_busy=st.worker_busy,
        pe_idle=st.worker_idle,
        technique=tech_name,
        scenario=spec.cluster.name or spec.name or "cluster",
        rdlb=spec.robustness.rdlb_enabled,
        adaptive_decisions=st.adaptive_decisions,
        t_wall=st.t_wall,
        chaos_events=st.chaos_events,
        trace=st.trace,
        metrics=st.metrics,
    )
