"""The port's batched simulator (repro_torch.core.devicesim) on the CPU.

Twins of every test in tests/test_devicesim.py, held against the port's
own scalar engine (``repro_torch.api.simulate``), and direct parity with
the reference's ``repro.core.devicesim.simulate_many`` on the same
lowerings.  All batched calls pass ``device="cpu"``.

Tolerances: ``t_par`` within 1e-9 absolute (both sides are float64; the
engine sums in another order), per-worker busy time likewise; the
``valid``/``hung`` flags and every integer field exactly.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from benchmarks import fig4_resilience
from repro import api as japi
from repro.core import devicesim as jds
from repro_torch import api
from repro_torch.adaptive import capture, sweep
from repro_torch.api import DEVICE_PORTFOLIO
from repro_torch.core import devicesim, faults

ATOL = 1e-9
CPU = "cpu"


def _spec(tech, P, *, rdlb=True, h=1e-4, fails=None, seed=0):
    sc = faults.baseline(P)
    if fails:
        for wid, ft in fails.items():
            sc.profiles[wid].fail_time = ft
    return api.RunSpec(
        scheduling=api.SchedulingSpec(technique=tech, seed=seed),
        robustness=api.RobustnessSpec(rdlb_enabled=rdlb),
        cluster=api.ClusterSpec.from_scenario(sc),
        execution=api.ExecutionSpec(h=h))


def _with_draw(spec, fail_row):
    prof = [faults.PEProfile(fail_time=None if np.isinf(f) else float(f))
            for f in fail_row]
    return dataclasses.replace(spec, cluster=api.ClusterSpec.from_scenario(
        faults.Scenario("draw", prof)))


def _check(spec, times, fail_times=None):
    """One batched element vs one scalar engine run; returns t_par."""
    res = devicesim.simulate_spec(spec, times, fail_times=fail_times,
                                  device=CPU)
    assert res is not None, "expected spec to lower"
    assert res.valid.all(), "budget must suffice at test scale"
    if fail_times is not None:
        spec = _with_draw(spec, fail_times[0])
    ref = api.simulate(spec, times)
    assert res.t_par[0] == pytest.approx(ref.t_par, abs=ATOL)
    assert res.n_assignments[0] == ref.n_assignments
    assert res.n_duplicates[0] == ref.n_duplicates
    assert res.n_finished[0] == ref.n_finished
    assert res.wasted_tasks[0] == ref.wasted_tasks
    np.testing.assert_allclose(res.pe_busy[0], ref.pe_busy, atol=ATOL)
    return float(res.t_par[0])


def _mc_draws(P, D, k, seed):
    rng = np.random.default_rng(seed)
    fail = np.full((D, P), np.inf)
    for d in range(D):
        v = rng.choice(np.arange(1, P), size=k, replace=False)
        fail[d, v] = rng.uniform(0.01, 0.12, size=k)
    return fail


# ------------------------------------------------------------- parity grid
@pytest.mark.parametrize("tech", ["SS", "STATIC", "mFSC", "FSC"])
@pytest.mark.parametrize("P", [4, 16, 64])
def test_parity_clean_grid(tech, P):
    """Failure-free grid over techniques x P x (divisible / partial-chunk
    / tiny) workloads, rdlb on and off — exercises both clean tails."""
    for N in (4 * P, 4 * P + 3, 100):
        times = np.full(N, 0.01)
        for rdlb in (True, False):
            _check(_spec(tech, P, rdlb=rdlb), times)


@pytest.mark.parametrize("tech", ["SS", "mFSC"])
@pytest.mark.parametrize("k", [1, 2, None])      # None -> P-1
def test_parity_failure_draws(tech, k):
    """Fail-stop draws: rdlb survives (finite t_par parity), the
    non-robust run hangs in BOTH engines (Fig. 1b)."""
    P, N = 8, 200
    k = P - 1 if k is None else k
    times = np.full(N, 0.01)
    rng = np.random.default_rng(k)
    fail = np.full((1, P), np.inf)
    victims = rng.choice(np.arange(1, P), size=k, replace=False)
    fail[0, victims] = rng.uniform(0.02, 0.15, size=k)
    t_rob = _check(_spec(tech, P, rdlb=True), times, fail_times=fail)
    assert np.isfinite(t_rob)
    res = devicesim.simulate_spec(_spec(tech, P, rdlb=False), times,
                                  fail_times=fail, device=CPU)
    assert res.valid.all() and res.hung.all() and np.isinf(res.t_par[0])
    assert api.simulate(_with_draw(_spec(tech, P, rdlb=False), fail[0]),
                        times).hang


def test_parity_latency_and_small_N():
    """Message latency and N < P (transaction tail from the start)."""
    for tech, P, N in (("SS", 8, 5), ("STATIC", 8, 5), ("SS", 16, 300)):
        spec = _spec(tech, P)
        spec = dataclasses.replace(
            spec, cluster=api.ClusterSpec(
                n_workers=P,
                workers=tuple(api.WorkerSpec(msg_latency=5e-4)
                              for _ in range(P))))
        _check(spec, np.full(N, 0.01))


def test_parity_monte_carlo_batch():
    """A batched MC cell (paired draws over 3 techniques) matches a
    per-draw scalar loop element-for-element."""
    P, N, D = 16, 160, 16
    times = np.full(N, 0.01)
    specs = [_spec(t, P) for t in ("SS", "mFSC", "FSC")]
    lows = [devicesim.lower_run(s, times)[0] for s in specs]
    assert all(lo is not None for lo in lows)
    fail = _mc_draws(P, D, 3, 7)
    res = devicesim.simulate_many(
        lows, tech_of=np.repeat(np.arange(3, dtype=np.int32), D),
        fail_times=np.tile(fail, (3, 1)), device=CPU)
    assert res.valid.all()
    for b in range(3 * D):
        t_ix, d = divmod(b, D)
        ref = api.simulate(_with_draw(specs[t_ix], fail[d]), times)
        assert res.t_par[b] == pytest.approx(ref.t_par, abs=ATOL), (b,)
        assert res.n_duplicates[b] == ref.n_duplicates
        assert res.n_assignments[b] == ref.n_assignments
        assert res.wasted_tasks[b] == ref.wasted_tasks


# ------------------------------------------------------------------ ties
def test_ties_resolve_in_worker_order(monkeypatch):
    """Equal arrival times are served lowest worker first, as the event
    heap serves them in push order: the clean tails' sorts are stable and
    the transaction tail's argmin takes the first minimum.  Task times
    equal to h make the partial chunk report exactly together with a
    full one (the sort sees ties); every transaction tail starts with all
    P requests tied at ``lat``."""
    seen = []
    order = devicesim._serve_order

    def spy(arrive):
        fin = torch.where(torch.isfinite(arrive), arrive, torch.nan)
        s = torch.sort(fin, dim=1).values
        seen.append(int((s[:, 1:] == s[:, :-1]).any(1).sum()))
        return order(arrive)

    monkeypatch.setattr(devicesim, "_serve_order", spy)
    h = 2.0 ** -10
    for tech in ("STATIC", "mFSC", "FSC"):
        for P in (4, 8):
            for N in range(2 * P + 1, 6 * P):
                _check(_spec(tech, P, h=h), np.full(N, h))
    assert sum(seen) > 0, "no tie reached a serve-order sort"
    # transaction tail: N < P, every request tied at t = lat = 0, so
    # without rDLB's duplicates the N tasks go to workers 0..N-1
    for P, N in ((8, 3), (16, 5)):
        res = devicesim.simulate_spec(_spec("SS", P, rdlb=False),
                                      np.full(N, 0.01), device=CPU)
        assert list(res.tasks_done[0]) == [1] * N + [0] * (P - N)
        for rdlb in (True, False):
            _check(_spec("SS", P, rdlb=rdlb), np.full(N, 0.01))


# --------------------------------------------------------- regime boundary
def test_declines_never_missimulates():
    """Everything outside the homogeneous fixed-chunk regime must DECLINE
    at lowering — falling back to the scalar engine, not mis-simulating —
    with the reference's own reason."""
    times = np.full(64, 0.01)
    declined = {}
    cases = {
        "adaptive_chunking": _spec("GSS", 4),
        "heterogeneous": dataclasses.replace(
            _spec("SS", 4), cluster=api.ClusterSpec(
                n_workers=4,
                workers=tuple(api.WorkerSpec(speed=s)
                              for s in (1.0, 1.0, 0.5, 0.5)))),
        "dup_cap": dataclasses.replace(
            _spec("SS", 4),
            robustness=api.RobustnessSpec(max_duplicates=2)),
        "h_zero": _spec("SS", 4, h=0.0),
        "adaptive_policy": dataclasses.replace(
            _spec("SS", 4), adaptive=api.AdaptiveSpec(enabled=True)),
        "process": _spec("SS", 4).override("execution.mode", "process"),
        "dead": dataclasses.replace(
            _spec("SS", 4), cluster=api.ClusterSpec(
                n_workers=4, workers=(api.WorkerSpec(alive=False),)
                + (api.WorkerSpec(),) * 3)),
        "count_fail": dataclasses.replace(
            _spec("SS", 4), cluster=api.ClusterSpec(
                n_workers=4, workers=(api.WorkerSpec(fail_after_tasks=3),)
                + (api.WorkerSpec(),) * 3)),
        "barrier": _spec("AWF-B", 4),
    }
    for name, spec in cases.items():
        lo, why = devicesim.lower_run(spec, times)
        assert lo is None, name
        declined[name] = why
        _, jwhy = jds.lower_run(japi.RunSpec.from_dict(spec.to_dict()),
                                times)
        assert why == jwhy, name
    # non-uniform task costs break the round-robin serve-order proof
    spread = np.linspace(0.01, 0.02, 64)
    lo, why = devicesim.lower_run(_spec("SS", 4), spread)
    assert lo is None and "spread" in why
    assert why == jds.lower_run(japi.RunSpec.from_dict(
        _spec("SS", 4).to_dict()), spread)[1]
    # ... and every reason is an actionable string, not empty
    assert all(declined.values())


def test_lowering_equals_reference():
    """A lowered spec carries the reference's tables and scalars."""
    for tech, N in (("SS", 100), ("STATIC", 67), ("FSC", 500)):
        spec = _spec(tech, 8, fails={3: 0.5})
        tt = np.full(N, 0.01)
        lo, _ = devicesim.lower_run(spec, tt)
        jlo, _ = jds.lower_run(japi.RunSpec.from_dict(spec.to_dict()), tt)
        for f in dataclasses.fields(lo):
            a, b = getattr(lo, f.name), getattr(jlo, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name
    for n in (1, 16, 17, 100, 255, 256, 300, 4097):
        assert devicesim._bucket(n) == jds._bucket(n)


def test_budget_exhaustion_flags_invalid():
    """An element that outruns its scan budget returns valid=False (the
    caller's cue to re-run on the scalar engine) — force it by calling
    the batch function with an artificially tiny round budget."""
    times = np.full(400, 0.01)
    spec = _spec("SS", 4)
    lo, _ = devicesim.lower_run(spec, times)

    def t(a):
        return torch.as_tensor(np.asarray(a))

    args = (t(np.zeros(1, np.int32)), t(np.ones(1, bool)),
            t(np.full((1, 4), np.inf)), t([lo.h]), t([lo.lat]),
            t([lo.speed]), t(lo.chunk_costs[None]), t(lo.chunk_sizes[None]),
            t(np.array([lo.n_chunks], np.int32)), t(np.array([lo.N])))
    for tail in ("sorted", "general", "txn"):
        res = devicesim._batch(*args, P=4, R_max=16, T_max=16, tail=tail)
        assert not bool(res[2][0]), tail         # valid flag
    ok = devicesim._batch(*args, P=4, R_max=devicesim._bucket(102),
                          T_max=0, tail="sorted")
    assert bool(ok[2][0])


def test_needs_a_gpu_unless_cpu_is_asked():
    """Without a GPU the batched path raises as device.resolve does: no
    call falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    times = np.full(64, 0.01)
    spec = _spec("SS", 4)
    lo, _ = devicesim.lower_run(spec, times)
    with pytest.raises(RuntimeError, match="no GPU"):
        devicesim.simulate_many([lo])
    with pytest.raises(RuntimeError, match="no GPU"):
        devicesim.simulate_spec(spec, times)
    adaptive = dataclasses.replace(spec, adaptive=api.AdaptiveSpec(
        enabled=True, device_sweep=True, portfolio=DEVICE_PORTFOLIO))
    with pytest.raises(RuntimeError, match="no GPU"):
        api.simulate(adaptive, times)
    assert api.simulate(adaptive, times, sim_device=CPU).n_finished == 64


# ------------------------------------------------------ forecaster parity
def test_device_sweep_matches_scalar_sweep():
    """The batched portfolio forecast ranks and scores candidates exactly
    as the scalar per-candidate loop (t=0 snapshot, live engine)."""
    from repro_torch.core import dls, engine, rdlb, simulator
    P, N = 8, 400
    tt = np.full(N, 0.01)
    tech = dls.make_technique("SS", N, P)
    queue = rdlb.RobustQueue(N, tech)
    eng = engine.Engine(
        queue, simulator.workers_from_scenario(faults.baseline(P)),
        simulator.SimBackend(tt))
    snap = capture(eng, 0.0)
    before = devicesim.batch_calls(CPU)
    scalar = sweep(snap, tt, DEVICE_PORTFOLIO, device=False)
    device = sweep(snap, tt, DEVICE_PORTFOLIO, device=True, sim_device=CPU)
    assert devicesim.batch_calls(CPU) > before
    assert [c.label for c, _ in device] == [c.label for c, _ in scalar]
    for (_, a), (_, b) in zip(device, scalar):
        assert a == pytest.approx(b, abs=ATOL)


def test_adaptive_run_device_flag_is_transparent():
    """An end-to-end adaptive run makes identical decisions with
    device_sweep on and off (the flag changes cost, not behaviour)."""
    tt = np.full(600, 0.01)

    def go(dev):
        spec = dataclasses.replace(
            _spec("mFSC", 8),
            adaptive=api.AdaptiveSpec(
                enabled=True, device_sweep=dev, decision_every_chunks=30,
                portfolio=(api.Candidate("SS"), api.Candidate("STATIC"),
                           api.Candidate("mFSC"))))
        return api.simulate(spec, tt, sim_device=CPU)
    a, b = go(True), go(False)
    assert a.t_par == pytest.approx(b.t_par, abs=ATOL)
    da = [(d.chosen, d.predictions) for d in a.adaptive_decisions]
    db = [(d.chosen, d.predictions) for d in b.adaptive_decisions]
    assert len(da) == len(db) and da
    for (ca, pa), (cb, pb) in zip(da, db):
        assert ca == cb
        assert pa.keys() == pb.keys()
        for k in pa:
            assert pa[k] == pytest.approx(pb[k], abs=1e-7)


# ----------------------------------------------------------- spec plumbing
def test_adaptivespec_device_flag_round_trips():
    spec = _spec("SS", 4)
    spec = dataclasses.replace(
        spec, adaptive=api.AdaptiveSpec(enabled=True, device_sweep=True))
    again = api.RunSpec.from_dict(spec.to_dict())
    assert again.adaptive.device_sweep is True
    assert again.adaptive.to_config().device_sweep is True
    assert spec.to_dict() == japi.RunSpec.from_dict(spec.to_dict()).to_dict()


def test_monte_carlo_smoke():
    """A tiny Monte-Carlo cell (the reference's draws and rho, the
    port's batch, invalid elements re-run on the scalar engine) gives
    finite rho with paired draws and the most robust technique pinned at
    1.0."""
    P, N, D, k, h = 8, 64, 32, 1, 1e-4
    times = np.full(N, 0.01)
    techs = ("SS", "mFSC", "FSC")
    specs = [_spec(t, P, h=h) for t in techs]
    lows = [devicesim.lower_run(s, times)[0] for s in specs]
    base = devicesim.simulate_many(lows, device=CPU)
    assert base.valid.all()
    fail = fig4_resilience._draw_failures(
        np.random.default_rng([0, k]), P, k, float(base.t_par.max()), D)
    res = devicesim.simulate_many(
        lows, tech_of=np.repeat(np.arange(3, dtype=np.int32), D),
        fail_times=np.tile(fail, (3, 1)), device=CPU)
    t_fail = np.where(res.hung, np.inf, res.t_par)
    for b in np.flatnonzero(~res.valid):
        t_ix, d = divmod(int(b), D)
        t_fail[b] = api.simulate(_with_draw(specs[t_ix], fail[d]),
                                 times).t_par
    rho = fig4_resilience._rho_per_draw(t_fail.reshape(3, D), base.t_par)
    means = rho.mean(axis=1)
    assert np.isfinite(means).all()
    assert min(means) == pytest.approx(1.0)


# ------------------------------------------- parity with the reference
@pytest.fixture
def reference_devicesim(monkeypatch):
    """The reference's ``simulate_many`` on the CPU.  It scopes float64
    with ``jax.experimental.enable_x64()``, which newer JAX releases
    moved to ``jax.enable_x64(True)``: supply that name where it is
    missing, for this test only, and let the reference import JAX
    afresh."""
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)
    monkeypatch.setattr(jds, "_JAX", None)
    return jds


def _assert_same_batch(got, want):
    """Every field element by element: flags and integers exactly,
    floats within ATOL with infinities in the same places."""
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.shape == b.shape, f.name
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(np.isinf(a), np.isinf(b),
                                          err_msg=f.name)
            fin = np.isfinite(b)
            np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=ATOL,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64),
                                          err_msg=f.name)


def _jlows(specs, times):
    return [jds.lower_run(japi.RunSpec.from_dict(s.to_dict()), times)[0]
            for s in specs]


def test_monte_carlo_batch_equals_reference(reference_devicesim):
    """The MC batch of three techniques x 16 draws, rdlb on and off:
    every output field of the port's batch equals the reference's."""
    P, N, D = 16, 160, 16
    times = np.full(N, 0.01)
    fail = _mc_draws(P, D, 3, 7)
    tech_of = np.repeat(np.arange(3, dtype=np.int32), D)
    for rdlb in (True, False):
        specs = [_spec(t, P, rdlb=rdlb) for t in ("SS", "mFSC", "FSC")]
        lows = [devicesim.lower_run(s, times)[0] for s in specs]
        got = devicesim.simulate_many(lows, tech_of=tech_of,
                                      fail_times=np.tile(fail, (3, 1)),
                                      device=CPU)
        want = reference_devicesim.simulate_many(
            _jlows(specs, times), tech_of=tech_of,
            fail_times=np.tile(fail, (3, 1)))
        _assert_same_batch(got, want)
        assert got.hung.any() != rdlb


@pytest.mark.parametrize("P,N", [(4, 19), (16, 64), (16, 67)])
def test_grid_points_equal_reference(reference_devicesim, P, N):
    """A few clean grid points (sorted and ring-walk tails, rdlb on and
    off, the four fixed-chunk techniques in one batch)."""
    times = np.full(N, 0.01)
    specs = [_spec(t, P, rdlb=rd) for t in ("SS", "STATIC", "mFSC", "FSC")
             for rd in (True, False)]
    lows = [devicesim.lower_run(s, times)[0] for s in specs]
    got = devicesim.simulate_many(lows, device=CPU)
    want = reference_devicesim.simulate_many(_jlows(specs, times))
    assert got.valid.all()
    _assert_same_batch(got, want)
