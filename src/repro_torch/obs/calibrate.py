"""Fit a calibrated RunSpec back from an observed run.

The sim-to-real gap this module closes: a declared spec says what the
cluster was *asked* to be (speeds, overhead h, latencies); a real run
shows what it *was*.  ``benchmarks/fig_cluster`` exposed the cost of
forecasting from declarations — a virtual twin driven by the declared
spec mispredicts a process run's t_par by tens of percent, because real
workers pay dispatch overhead, scheduling noise, and composed
perturbations the declaration never mentions.  Mohammed et al.
(arXiv 1910.06844) show simulated forecasts only match real runs when
measured per-PE speeds and overheads are fed back into the simulator;
:func:`calibrate_trace` is that feedback path, computed from the flight
recorder's event stream:

  * per-worker **speed** — Σ nominal task cost / Σ measured execution
    seconds over that worker's EXEC chunks (nominal costs from the
    workload's prefix sums).  Workers with too few observed chunks fall
    back to ``declared speed × pooled ratio`` and carry a
    reason-annotated residual instead of a fabricated per-worker fit.
  * **h** (master transaction overhead) — the p50 of per-transaction
    dispatch latencies (only for wall-clock traces; a virtual-clock
    trace reproduces the declared h by construction).
  * per-worker **msg_latency** — from the median idle gap between a
    worker's consecutive chunks: ``gap ≈ h + 2·latency`` in the virtual
    cost model, so ``latency = max(0, (gap − h) / 2)``.

Declared *perturbations* (fail_time, hang_time, fail_after_tasks,
sleep_per_task, alive) are preserved — the calibrated spec describes the
same scenario, measured rather than declared, so a virtual twin replays
the same chaos under calibrated conditions.

:class:`SpecCalibrator` is the in-loop variant the adaptive controller
uses (``AdaptiveSpec.calibrate=True``): per-worker measured rates come
from the engine's own ``PEStats`` (no trace required), an EWMA drift
detector decides when measured conditions have diverged enough from the
speeds the forecaster is currently using, and re-calibration swaps the
forecast basis — logged on the controller's DecisionRecords.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.core.trace import EV_EXEC, EV_FF_SPAN, Trace
from repro_torch.obs.metrics import EWMA

__all__ = ["Residual", "CalibrationResult", "calibrate_trace",
           "SpecCalibrator"]

#: below this many observed EXEC chunks a per-worker speed fit is noise
MIN_CHUNKS = 2
#: below this many dispatch transactions the h fit is noise
MIN_DISPATCHES = 5


@dataclasses.dataclass(frozen=True)
class Residual:
    """One declared-vs-measured delta, with the decision taken on it.

    ``applied=False`` means the calibrated spec kept the declared value;
    ``reason`` says why (insufficient samples, virtual clock, ...).
    """
    field: str            # e.g. "cluster.workers[3].speed", "execution.h"
    wid: Optional[int]
    declared: Any
    measured: Any
    applied: bool
    reason: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        mark = "applied" if self.applied else "kept declared"
        s = (f"{self.field}: declared={_fmt(self.declared)} "
             f"measured={_fmt(self.measured)} [{mark}]")
        return s + (f" ({self.reason})" if self.reason else "")


def _fmt(v) -> str:
    return f"{v:.6g}" if isinstance(v, float) else str(v)


@dataclasses.dataclass
class CalibrationResult:
    """Calibrated spec + the evidence it was fit from."""
    spec: Any                       # calibrated RunSpec
    declared: Any                   # the input RunSpec
    residuals: list                 # [Residual]
    measured: dict                  # raw per-worker / global measurements

    def summary(self) -> str:
        lines = [f"calibration: {len(self.residuals)} residuals, "
                 f"{sum(1 for r in self.residuals if r.applied)} applied"]
        lines += [f"  {r}" for r in self.residuals]
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return dict(spec=self.spec.to_dict(),
                    declared=self.declared.to_dict(),
                    residuals=[r.to_dict() for r in self.residuals],
                    measured=self.measured)


def _nominal_cost(task_times, start: int, size: int) -> float:
    """Declared cost of tasks [start, start+size) via prefix sums."""
    prefix = task_times
    return float(prefix[start + size] - prefix[start])


def calibrate_trace(trace: Trace, declared, task_times=None) -> CalibrationResult:
    """Fit measured speeds / h / latency back onto ``declared``.

    ``task_times`` is the workload (nominal per-task seconds); without
    it, per-worker speed fits are impossible (there is no nominal
    baseline to divide by) and only h / latency are calibrated.
    """
    residuals: list[Residual] = []
    measured: dict = {}
    wall = trace.meta.get("clock", "virtual") == "wall"
    cluster = declared.cluster
    specs = list(cluster.worker_specs())
    P = len(specs)

    prefix = None
    if task_times is not None and len(task_times):
        prefix = np.concatenate(
            ([0.0], np.cumsum(np.asarray(task_times, dtype=np.float64))))

    # ---------------------------------------------------- per-worker speed
    is_exec = np.isin(trace.kind, (EV_EXEC, EV_FF_SPAN))
    idx = np.flatnonzero(is_exec)
    per: dict[int, dict] = {}
    for i in idx:
        w = int(trace.wid[i])
        size = int(trace.size[i])
        dt = float(trace.dt[i])
        if size <= 0 or dt <= 0:
            continue
        d = per.setdefault(w, dict(chunks=0, measured_s=0.0,
                                   nominal_s=0.0, t=[]))
        d["chunks"] += 1
        d["measured_s"] += dt
        if prefix is not None:
            start = int(trace.start[i])
            if 0 <= start and start + size < len(prefix):
                d["nominal_s"] += _nominal_cost(prefix, start, size)
        d["t"].append((float(trace.t[i]), dt))

    speeds: dict[int, float] = {}
    ratios: list[tuple] = []     # (ratio measured/declared, weight)
    for w, d in per.items():
        if d["nominal_s"] > 0 and d["measured_s"] > 0:
            d["speed"] = d["nominal_s"] / d["measured_s"]
            if 0 <= w < P:
                decl = specs[w].speed
                if decl > 0 and d["chunks"] >= MIN_CHUNKS:
                    ratios.append((d["speed"] / decl, d["chunks"]))
    pooled_ratio = (sum(r * n for r, n in ratios)
                    / sum(n for _, n in ratios)) if ratios else None
    measured["pooled_speed_ratio"] = pooled_ratio

    if prefix is None:
        residuals.append(Residual(
            field="cluster.workers[*].speed", wid=None,
            declared=None, measured=None, applied=False,
            reason="no workload given — nominal task costs unknown"))
    else:
        for w in range(P):
            decl = specs[w].speed
            d = per.get(w)
            if d and d.get("speed") and d["chunks"] >= MIN_CHUNKS:
                speeds[w] = d["speed"]
                residuals.append(Residual(
                    field=f"cluster.workers[{w}].speed", wid=w,
                    declared=decl, measured=d["speed"], applied=True,
                    reason=f"fit over {d['chunks']} chunks"))
            elif pooled_ratio is not None:
                speeds[w] = decl * pooled_ratio
                n = d["chunks"] if d else 0
                residuals.append(Residual(
                    field=f"cluster.workers[{w}].speed", wid=w,
                    declared=decl, measured=speeds[w], applied=True,
                    reason=f"only {n} chunks observed — pooled ratio "
                           f"{pooled_ratio:.3f} × declared"))
            else:
                residuals.append(Residual(
                    field=f"cluster.workers[{w}].speed", wid=w,
                    declared=decl, measured=None, applied=False,
                    reason="no execution observed for this worker"))

    # ------------------------------------------------------- dispatch h
    d_lat = trace.dispatch_latency()
    measured["dispatch_latency"] = d_lat
    h_used = declared.execution.h
    if wall and d_lat["n"] >= MIN_DISPATCHES:
        h_used = d_lat["p50"]
        residuals.append(Residual(
            field="execution.h", wid=None,
            declared=declared.execution.h, measured=h_used, applied=True,
            reason=f"dispatch-latency p50 over {d_lat['n']} transactions"))
    else:
        residuals.append(Residual(
            field="execution.h", wid=None,
            declared=declared.execution.h, measured=d_lat["p50"],
            applied=False,
            reason=("virtual-clock trace reproduces declared h"
                    if not wall else
                    f"only {d_lat['n']} dispatch transactions observed")))

    # --------------------------------------------------- message latency
    # idle gap between a worker's consecutive chunks ≈ h + 2·latency
    gaps: list[float] = []
    for w, d in per.items():
        spans = sorted(d["t"])
        for (t0, dt0), (t1, _) in zip(spans, spans[1:]):
            g = t1 - (t0 + dt0)
            if g > 0:
                gaps.append(g)
    lat_meas = None
    if wall and len(gaps) >= MIN_DISPATCHES:
        gap_med = float(np.median(gaps))
        measured["interchunk_gap_p50"] = gap_med
        lat_meas = max(0.0, (gap_med - h_used) / 2.0)
        residuals.append(Residual(
            field="cluster.workers[*].msg_latency", wid=None,
            declared=[s.msg_latency for s in specs], measured=lat_meas,
            applied=True,
            reason=f"(median inter-chunk gap {gap_med:.6g}s − h)/2 "
                   f"over {len(gaps)} gaps"))
    else:
        residuals.append(Residual(
            field="cluster.workers[*].msg_latency", wid=None,
            declared=[s.msg_latency for s in specs], measured=None,
            applied=False,
            reason=("virtual-clock trace reproduces declared latency"
                    if not wall else
                    f"only {len(gaps)} inter-chunk gaps observed")))

    measured["workers"] = {
        int(w): {k: v for k, v in d.items() if k != "t"}
        for w, d in sorted(per.items())}

    # ----------------------------------------------- build calibrated spec
    new_workers = []
    for w in range(P):
        s = specs[w]
        changes: dict = {}
        if w in speeds:
            changes["speed"] = speeds[w]
        if lat_meas is not None:
            changes["msg_latency"] = lat_meas
        new_workers.append(dataclasses.replace(s, **changes)
                           if changes else s)
    spec = declared.replace(cluster=dataclasses.replace(
        cluster, workers=tuple(new_workers)))
    if h_used != declared.execution.h:
        spec = spec.override("execution.h", h_used)
    return CalibrationResult(spec=spec, declared=declared,
                             residuals=residuals, measured=measured)


class SpecCalibrator:
    """In-loop calibration + EWMA drift detection for the adaptive
    controller.

    At each re-plan the controller hands over the live
    ``EngineSnapshot``; per-worker measured speed comes from the
    engine's own ``PEStats`` (``rate(include_overhead=False) × mean
    nominal task cost`` — nominal work per measured compute second).
    The calibrator tracks, per worker, an EWMA of relative drift between
    that measurement and the speed the forecaster is *currently* using;
    when the worst drift exceeds ``threshold`` (or on the first snapshot
    with data), the calibrated speeds are (re-)adopted and every sweep
    from then on forecasts from measured conditions.
    """

    def __init__(self, task_times=None, threshold: float = 0.15,
                 alpha: float = 0.5, min_samples: int = 2) -> None:
        self.mean_task = (float(np.mean(task_times))
                          if task_times is not None and len(task_times)
                          else None)
        self.threshold = threshold
        self.alpha = alpha
        self.min_samples = min_samples
        self.n_calibrations = 0
        self._used: dict[int, float] = {}   # wid -> speed in use
        self._drift: dict[int, EWMA] = {}

    def _measured(self, snap) -> dict:
        """wid -> measured effective speed, for workers with evidence."""
        out: dict[int, float] = {}
        if self.mean_task is None:
            return out
        for w in snap.workers:
            st = getattr(w, "stats", None)
            if (w.alive and st is not None
                    and st.n_samples >= self.min_samples
                    and st.compute_time > 0):
                out[w.wid] = st.rate(False) * self.mean_task
        return out

    def apply(self, snap, declared_speeds=None):
        """Return ``(snapshot', info)`` — the snapshot the forecaster
        should sweep from, plus a JSON-safe record of what happened."""
        meas = self._measured(snap)
        info: dict = dict(enabled=True, adopted=False,
                          n_calibrations=self.n_calibrations,
                          max_drift=0.0, measured={})
        if not meas:
            info["reason"] = ("no workload mean available"
                              if self.mean_task is None
                              else "no worker has enough samples yet")
            return snap, info
        info["measured"] = {int(w): round(v, 6)
                            for w, v in sorted(meas.items())}
        # drift of the measurement vs. the speed forecasts currently use
        max_drift = 0.0
        for w in snap.workers:
            if w.wid not in meas:
                continue
            used = self._used.get(w.wid, w.speed)
            rel = (abs(meas[w.wid] - used) / used) if used > 0 else 0.0
            ew = self._drift.setdefault(w.wid, EWMA(alpha=self.alpha))
            ew.add(rel)
            max_drift = max(max_drift, ew.value)
        info["max_drift"] = round(max_drift, 6)

        first = self.n_calibrations == 0
        if first or max_drift > self.threshold:
            self._used.update(meas)
            self.n_calibrations += 1
            for w in meas:
                self._drift[w] = EWMA(alpha=self.alpha)  # reset vs new base
            info["adopted"] = True
            info["n_calibrations"] = self.n_calibrations
            info["reason"] = ("initial calibration" if first else
                              f"drift {max_drift:.3f} > "
                              f"threshold {self.threshold}")
        if not self._used:
            return snap, info
        new_workers = [
            dataclasses.replace(w, speed=self._used[w.wid])
            if w.wid in self._used else w
            for w in snap.workers]
        snap2 = dataclasses.replace(snap, workers=new_workers)
        return snap2, info
