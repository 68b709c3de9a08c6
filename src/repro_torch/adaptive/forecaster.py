"""Forecaster: resume the discrete-event simulator from a snapshot.

For each :class:`Candidate` — a *spec delta* (repro_torch.api.spec) — build the
*remainder* of the run as a RunSpec: unfinished tasks, surviving workers
at their current speed/latency, the incumbent's rDLB knobs; apply the
delta; and run the exact engine loop over it to predict the remaining
``T_par``.  Because PR 1 made the simulator and the real executors share
one engine, this prediction exercises the identical scheduling path the
live run will take (the SimAS property).

Candidates being spec deltas means the portfolio sweep can explore ANY
spec field — ``Candidate("GSS")`` swaps the technique,
``Candidate(max_duplicates=2)`` the duplication aggressiveness, and
``Candidate(overrides=(("execution.h", 5e-3),))`` forecasts under a
different master overhead — not just technique × dup-knobs.

With ``max_sim_tasks=None`` a forecast is EXACTLY a fresh simulation of
the remainder (asserted for the reference by tests/test_adaptive.py);
setting it groups consecutive tasks into summed meta-tasks so a full
portfolio sweep stays cheap enough to run in-loop.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch import api
from repro_torch.adaptive.snapshot import EngineSnapshot
# Candidate became a RunSpec delta (repro_torch.api.spec); re-exported here for
# back-compat with the original portfolio vocabulary.
from repro_torch.api.spec import Candidate, DEFAULT_PORTFOLIO  # noqa: F401
from repro_torch.core import dls, faults, simulator


def scenario_from_snapshot(snap: EngineSnapshot) -> faults.Scenario:
    """Worker profiles as known at capture: survivors only, at their
    current speed/latency.  Future fail-stops are unknowable and absent."""
    profiles = [faults.PEProfile(speed=w.speed, msg_latency=w.msg_latency)
                for w in snap.workers if w.alive]
    if not profiles:                    # all dead: forecast degenerates
        profiles = [faults.PEProfile()]
    return faults.Scenario(f"resume@{snap.t:.4g}", profiles)


def base_spec_from_snapshot(snap: EngineSnapshot, *, h: float = 1e-4,
                            seed: int = 0,
                            horizon: float = 1e7) -> "api.RunSpec":
    """The incumbent, as a RunSpec over the remainder: current technique
    and rDLB knobs, surviving workers at observed conditions.  Candidate
    deltas apply on top of this."""
    return api.RunSpec(
        scheduling=api.SchedulingSpec(technique=snap.technique, seed=seed,
                                      params=(("h", h),)),
        robustness=api.RobustnessSpec(
            rdlb_enabled=snap.rdlb_enabled,
            max_duplicates=snap.max_duplicates,
            barrier_max_duplicates=snap.barrier_max_duplicates),
        cluster=api.ClusterSpec.from_scenario(scenario_from_snapshot(snap)),
        execution=api.ExecutionSpec(h=h, horizon=horizon))


def remaining_times(snap: EngineSnapshot,
                    task_times: Sequence[float]) -> np.ndarray:
    """Nominal times of the snapshot's unfinished tasks, in id order."""
    tt = np.asarray(task_times, dtype=float)
    if len(tt) != snap.n_tasks:
        raise ValueError(f"task_times has {len(tt)} entries for a "
                         f"{snap.n_tasks}-task snapshot")
    return tt[np.asarray(snap.remaining, dtype=int)]


def coarsen_times(times: np.ndarray,
                  max_tasks: Optional[int]) -> np.ndarray:
    """Group consecutive tasks into <= max_tasks meta-tasks (times sum),
    bounding forecast cost while preserving total work and its spatial
    variance structure.  One vectorized ``np.add.reduceat`` over the
    ``np.array_split`` block boundaries — no per-group Python loop."""
    times = np.asarray(times, dtype=float)
    if max_tasks is None or len(times) <= max_tasks:
        return times
    div, mod = divmod(len(times), max_tasks)
    # np.array_split block starts: the first `mod` blocks get div+1
    starts = np.arange(max_tasks) * div
    starts[:mod] += np.arange(mod)
    starts[mod:] += mod
    return np.add.reduceat(times, starts)


def _prepare(snap: EngineSnapshot, task_times: Sequence[float], *,
             h: float = 1e-4, seed: int = 0,
             max_sim_tasks: Optional[int] = None, horizon: float = 1e7):
    """Snapshot-derived inputs shared by EVERY candidate forecast —
    remainder times, the coarsened simulation workload, the incumbent
    base spec and the survivors' learned stats — computed ONCE per sweep
    instead of once per candidate."""
    rem = remaining_times(snap, task_times)
    times = coarsen_times(rem, max_sim_tasks)
    base = base_spec_from_snapshot(snap, h=h, seed=seed, horizon=horizon)
    alive_stats = [w.stats if w.stats is not None else dls.PEStats()
                   for w in snap.workers if w.alive]
    scale = len(rem) / len(times) if len(times) else 1.0
    return rem, times, base, alive_stats, scale


def _build_candidate(times, base, alive_stats, scale, cand, prewarm):
    """Candidate delta -> (remainder spec, prewarmed technique)."""
    spec = cand.apply(base)
    tech = api.make_scheduler(spec, len(times))
    if prewarm and alive_stats:
        tech.adopt_stats(alive_stats, time_scale=scale)
    return spec, tech


def _forecast_one(times, base, alive_stats, scale, cand, prewarm) -> float:
    spec, tech = _build_candidate(times, base, alive_stats, scale, cand,
                                  prewarm)
    res = api.simulate(spec, times, technique=tech)
    return float(res.t_par)


def forecast_candidate(snap: EngineSnapshot,
                       task_times: Sequence[float],
                       cand: Candidate, *,
                       h: float = 1e-4,
                       seed: int = 0,
                       max_sim_tasks: Optional[int] = None,
                       prewarm: bool = True,
                       horizon: float = 1e7) -> float:
    """Predicted remaining ``T_par`` if the run switched to ``cand`` now.

    ``prewarm`` seeds the candidate technique with the snapshot's learned
    per-PE measurements (renumbered to the survivors), so AWF-*/AF start
    from what the run has already observed instead of cold.  Returns
    ``inf`` if the forecast itself hangs.
    """
    rem, times, base, alive_stats, scale = _prepare(
        snap, task_times, h=h, seed=seed, max_sim_tasks=max_sim_tasks,
        horizon=horizon)
    if len(rem) == 0:
        return 0.0
    return _forecast_one(times, base, alive_stats, scale, cand, prewarm)


def _device_sweep(portfolio, times, base, alive_stats, scale, prewarm,
                  sim_device=None):
    """Batch every lowerable candidate into ONE batched call on the torch
    device ``sim_device`` (``repro_torch.device.resolve``: the card unless
    the caller names the CPU; no GPU raises, nothing falls back).

    Returns ``(preds, scalar_rest)``: candidates outside the device
    regime (adaptive chunking, finite dup caps, heterogeneous overrides,
    budget-exhausted elements, ...) land in ``scalar_rest`` and are
    forecast by the exact engine — the device path degrades to the
    oracle, never silently mis-simulates.
    """
    from repro_torch.core import devicesim
    lows, cands, rest = [], [], []
    for cand in portfolio:
        spec, tech = _build_candidate(times, base, alive_stats, scale,
                                      cand, prewarm)
        lo, _ = devicesim.lower_run(spec, times, technique=tech)
        if lo is None or (lows and lo.P != lows[0].P):
            rest.append(cand)
        else:
            lows.append(lo)
            cands.append(cand)
    if not lows:
        return [], rest
    res = devicesim.simulate_many(lows, device=sim_device)
    preds = []
    for i, cand in enumerate(cands):
        if res.valid[i]:
            preds.append((cand, float(res.t_par[i])))
        else:
            rest.append(cand)
    return preds, rest


def sweep(snap: EngineSnapshot, task_times: Sequence[float],
          portfolio: Sequence[Candidate] = DEFAULT_PORTFOLIO, *,
          prewarm: bool = True, device: bool = False, sim_device=None,
          **kw) -> list[tuple[Candidate, float]]:
    """Forecast every candidate; returns [(candidate, predicted T_par)]
    sorted best-first (hung forecasts rank last at inf).

    ``device=True`` batches all candidates inside the homogeneous
    fixed-chunk regime (see :data:`repro_torch.api.DEVICE_PORTFOLIO`) into
    one batched ``core.devicesim`` call on the torch device ``sim_device``
    (None = the card); the rest — and anything the batched path declines
    — fall back to the scalar engine, candidate by candidate, so the
    ranking is unchanged up to float64 round-off."""
    rem, times, base, alive_stats, scale = _prepare(snap, task_times, **kw)
    if len(rem) == 0:
        preds = [(c, 0.0) for c in portfolio]
    else:
        preds, rest = ([], list(portfolio))
        if device:
            preds, rest = _device_sweep(portfolio, times, base,
                                        alive_stats, scale, prewarm,
                                        sim_device)
        preds += [(c, _forecast_one(times, base, alive_stats, scale, c,
                                    prewarm))
                  for c in rest]
    preds.sort(key=lambda p: (p[1], p[0].label))
    return preds


def run_static(task_times: Sequence[float], scenario: faults.Scenario,
               cand: Candidate, *, h: float = 1e-4, seed: int = 0,
               horizon: float = 1e7) -> simulator.SimResult:
    """Full static run of one candidate, start to finish — the oracle
    baseline the adaptive policy is judged against."""
    times = np.asarray(task_times, dtype=float)
    base = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="FAC", seed=seed,
                                      params=(("h", h),)),
        cluster=api.ClusterSpec.from_scenario(scenario),
        execution=api.ExecutionSpec(h=h, horizon=horizon))
    return api.simulate(cand.apply(base), times)
