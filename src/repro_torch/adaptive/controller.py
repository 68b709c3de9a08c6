"""Controller: watch a live engine run, re-plan the remainder, hot-swap.

The engine calls two duck-typed hooks (no import cycle — the engine never
imports this package):

  * ``bind(engine)`` once at run start — resets per-run state and, with
    ``plan_at_start``, makes an initial SimAS-style selection before the
    first chunk is sized;
  * ``on_report(engine, t)`` after every master report transaction — the
    decision cadence (every k chunks and/or every d virtual seconds)
    triggers a re-plan here, BEFORE the piggybacked next assignment, so a
    swap takes effect on the very next chunk.

A re-plan snapshots the run (repro_torch.adaptive.snapshot), forecasts every
portfolio candidate plus the incumbent over the remainder
(repro_torch.adaptive.forecaster), and — if the best candidate beats the
incumbent by more than ``hysteresis`` — swaps the queue's technique and
rDLB knobs in place.  The swap preserves exactly-once task accounting by
construction: ``RobustQueue.swap_technique`` never touches task flags or
duplicate bookkeeping, and the incoming technique is pre-warmed with the
learned per-PE measurements so adaptive techniques do not restart cold.

In threaded mode ``on_report`` is called OUTSIDE the engine's commit
lock (a forecast sweep must not stall other workers' commits), so the
controller serializes re-plans itself: the cadence counter is updated
under a small lock and at most one thread runs a sweep at a time —
late-comers skip rather than queue up.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional, Sequence

import numpy as np

from repro_torch.adaptive.forecaster import Candidate, DEFAULT_PORTFOLIO, sweep
from repro_torch.adaptive.snapshot import capture


@dataclasses.dataclass
class AdaptiveConfig:
    """Knobs for the adaptive policy.

    decision_every_chunks: re-plan after this many completion reports
        (None disables the chunk-count cadence).
    decision_every_time:   re-plan when this much virtual time (wall time
        in threaded mode) has passed since the last decision (None
        disables the time cadence).
    plan_at_start:  make an initial selection at t=0 (SimAS: simulate
        before executing, then keep watching).
    max_decisions:  total re-plans per run (forecast-cost bound).
    min_remaining:  skip mid-run re-plans when fewer unfinished tasks
        remain (the tail is cheaper to finish than to re-plan).
    hysteresis:     swap only if the best candidate's predicted T_par is
        at least this fraction below the incumbent's.
    max_sim_tasks:  forecast coarsening cap (None = exact remainder).
    prewarm:        seed candidate techniques with learned PE stats.
    forecast_h:     master overhead for forecasts (None = engine's h).
    device_sweep:   batch the portfolio forecast into one batched call
        of core.devicesim on the controller's ``sim_device`` (candidates
        outside the homogeneous fixed-chunk regime fall back to the
        scalar engine).
    calibrate:      forecast every sweep from the CALIBRATED cluster
        state: per-worker measured speeds (PEStats-derived) replace the
        snapshot's declared speeds (repro_torch.obs.calibrate.SpecCalibrator).
    drift_threshold: re-calibrate when the worst per-worker EWMA drift
        between measured speed and the speed forecasts currently use
        exceeds this fraction.
    drift_alpha:    EWMA smoothing for the drift detector.
    """
    portfolio: tuple = DEFAULT_PORTFOLIO
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


@dataclasses.dataclass
class DecisionRecord:
    """One re-planning decision (kept on the controller and surfaced via
    ``EngineStats.adaptive_decisions``)."""
    t: float
    n_remaining: int
    predictions: dict           # candidate label -> predicted T_par
    incumbent: str              # label of the technique/knobs before
    chosen: str                 # label after (== incumbent if no swap)
    swapped: bool
    calibration: Optional[dict] = None
                                # SpecCalibrator evidence when the sweep
                                # forecast from calibrated state
                                # (AdaptiveSpec.calibrate): measured
                                # speeds, EWMA drift, whether this
                                # decision (re-)adopted a calibration

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # forecast T_par may be inf (a predicted hang) — keep it JSON-safe
        d["predictions"] = {k: (None if v != v or v in (float("inf"),
                                                       float("-inf"))
                                else float(v))
                            for k, v in self.predictions.items()}
        return d


class AdaptiveController:
    """Simulation-in-the-loop technique selection with mid-run hot-swap.

    ``task_times`` are the nominal per-task costs the forecaster
    simulates over; None means unit-cost tasks (the executors' model,
    where a task is a microbatch or a request), resolved to
    ``np.ones(N)`` at bind time.  ``sim_device`` is the torch device of
    ``device_sweep`` forecasts (None = the card; ``"cpu"`` to run them on
    the host).  One controller instance may be reused across runs —
    ``bind`` resets all per-run state.
    """

    def __init__(self, task_times: Optional[Sequence[float]] = None,
                 config: Optional[AdaptiveConfig] = None,
                 sim_device=None) -> None:
        self.config = config or AdaptiveConfig()
        self.sim_device = sim_device
        self.task_times = (None if task_times is None
                           else np.asarray(task_times, dtype=float))
        self.decisions: list[DecisionRecord] = []
        self._tt: Optional[np.ndarray] = None
        self._reports = 0
        self._next_t: Optional[float] = None
        self._lock = threading.Lock()
        self._replanning = False
        self._calibrator = None

    # -------------------------------------------------------- engine hooks
    def bind(self, engine) -> None:
        cfg = self.config
        self.decisions = []
        self._reports = 0
        self._replanning = False
        self._next_t = (cfg.decision_every_time
                        if cfg.decision_every_time is not None else None)
        self._tt = (self.task_times if self.task_times is not None
                    else np.ones(engine.queue.N))
        if len(self._tt) != engine.queue.N:
            raise ValueError(
                f"controller has {len(self._tt)} task times for a "
                f"{engine.queue.N}-task queue")
        self._calibrator = None
        if cfg.calibrate:
            from repro_torch.obs.calibrate import SpecCalibrator  # lazy: no cycle
            self._calibrator = SpecCalibrator(
                task_times=self._tt,
                threshold=cfg.drift_threshold,
                alpha=cfg.drift_alpha)
        if cfg.plan_at_start:
            self.replan(engine, 0.0)

    def on_report(self, engine, t: float) -> None:
        cfg = self.config
        with self._lock:
            self._reports += 1
            due = (cfg.decision_every_chunks is not None
                   and self._reports >= cfg.decision_every_chunks)
            if (cfg.decision_every_time is not None
                    and self._next_t is not None and t >= self._next_t):
                due = True
            if (not due or len(self.decisions) >= cfg.max_decisions
                    or self._replanning):
                return
            self._reports = 0
            if cfg.decision_every_time is not None:
                self._next_t = t + cfg.decision_every_time
            self._replanning = True
        try:
            self.replan(engine, t)
        finally:
            with self._lock:
                self._replanning = False

    # ----------------------------------------------------------- re-planning
    @staticmethod
    def incumbent_candidate(queue) -> Candidate:
        # A pure "stay" delta: the base spec the forecaster builds from
        # the snapshot already carries the queue's current dup knobs, so
        # the incumbent keeps every field (and compares equal to a plain
        # Candidate(technique) portfolio entry).
        return Candidate(queue.technique.name)

    def replan(self, engine, t: float) -> Optional[DecisionRecord]:
        """Snapshot -> portfolio forecast -> (maybe) hot-swap."""
        cfg = self.config
        snap = capture(engine, t)
        n_remaining = snap.n_remaining
        if n_remaining == 0 or (self.decisions
                                and n_remaining < cfg.min_remaining):
            return None
        calib_info = None
        if self._calibrator is not None:
            # forecast from measured conditions, not declared ones; the
            # calibrator only swaps snapshot speeds, so the sweep itself
            # is unchanged
            snap, calib_info = self._calibrator.apply(snap)
        incumbent = self.incumbent_candidate(engine.queue)
        portfolio = tuple(cfg.portfolio)
        if incumbent not in portfolio:
            portfolio += (incumbent,)
        h = cfg.forecast_h if cfg.forecast_h is not None else engine.h
        preds = sweep(snap, self._tt, portfolio, h=h, seed=cfg.seed,
                      max_sim_tasks=cfg.max_sim_tasks,
                      prewarm=cfg.prewarm, device=cfg.device_sweep,
                      sim_device=self.sim_device)
        by_cand = dict(preds)
        best, best_t = preds[0]
        inc_t = by_cand[incumbent]
        swapped = False
        if (best != incumbent and math.isfinite(best_t)
                and (not math.isfinite(inc_t)
                     or best_t < inc_t * (1.0 - cfg.hysteresis))):
            self._swap(engine, best, n_remaining)
            swapped = True
        rec = DecisionRecord(
            t=t, n_remaining=n_remaining,
            predictions={c.label: p for c, p in preds},
            incumbent=incumbent.label,
            chosen=best.label if swapped else incumbent.label,
            swapped=swapped,
            calibration=calib_info)
        self.decisions.append(rec)
        return rec

    def _swap(self, engine, cand: Candidate, n_remaining: int) -> None:
        """Hot-swap the queue's technique/knobs for the remainder.

        The candidate is a spec DELTA: it is applied to a spec describing
        the queue's current state, and the resulting scheduling/
        robustness sections drive the swap (other overridden sections —
        e.g. execution — only affect forecasts; a live engine cannot
        change its h mid-run).  The new technique is sized for the
        remaining work but keeps the FULL worker numbering (its stats are
        indexed by original wid — dead workers simply never request), and
        inherits the incumbent's learned measurements.
        """
        from repro_torch import api
        q = engine.queue
        old = q.technique
        incumbent = api.RunSpec(
            scheduling=api.SchedulingSpec(technique=old.name,
                                          seed=self.config.seed,
                                          params=(("h", engine.h),)),
            robustness=api.RobustnessSpec(
                rdlb_enabled=q.rdlb_enabled,
                max_duplicates=q.max_duplicates,
                barrier_max_duplicates=q.barrier_max_duplicates),
            cluster=api.ClusterSpec(n_workers=len(engine.workers)))
        spec = cand.apply(incumbent)
        tech = api.make_scheduler(spec, max(1, n_remaining))
        if self.config.prewarm:
            tech.adopt_stats(old.stats)
        q.swap_technique(
            tech, max_duplicates=spec.robustness.max_duplicates,
            barrier_max_duplicates=spec.robustness.barrier_max_duplicates,
            rdlb_enabled=spec.robustness.rdlb_enabled)
