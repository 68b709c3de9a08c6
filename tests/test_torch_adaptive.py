"""The port's adaptive re-planning (repro_torch.adaptive) against the
reference's (repro.adaptive): snapshots, forecasts, the controller's
decision sequence with ``device_sweep`` on and off, the spec wiring and
the executors' ``adaptive=`` hook.  Batched forecasts run with
``sim_device="cpu"``.

Tolerances: a decision's chosen candidate, incumbent, instant and
remaining count exactly; its predictions within 1e-7 (the reference's
own device-on/off bound); ``t_par`` within 1e-9; counters exactly.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.experimental
import numpy as np
import pytest

from repro import api as japi
from repro.adaptive import capture as jcapture
from repro.adaptive import sweep as jsweep
from repro.core import devicesim as jds
from repro.core import dls as jdls
from repro.core import engine as jengine
from repro.core import faults as jfaults
from repro.core import rdlb as jrdlb
from repro.core import simulator as jsim
from repro_torch import api
from repro_torch.adaptive import (AdaptiveConfig, AdaptiveController,
                                  Candidate, capture, run_adaptive, sweep)
from repro_torch.core import devicesim, dls, engine, faults, rdlb, simulator

CPU = "cpu"
PORTFOLIO = tuple(Candidate(t) for t in ("FAC", "GSS", "mFSC", "AWF-C",
                                         "AF"))


@pytest.fixture
def reference_devicesim(monkeypatch):
    """Let the reference's batched forecasts run on newer JAX, where
    ``jax.experimental.enable_x64`` became ``jax.enable_x64(True)``
    (as in tests/test_torch_devicesim.py)."""
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64",
                            lambda: jax.enable_x64(True), raising=False)
    monkeypatch.setattr(jds, "_JAX", None)
    assert jds.device_available()


def task_times(n, seed=0, mean=0.01, sd=0.004):
    rng = np.random.default_rng(seed)
    return np.abs(rng.normal(mean, sd, n)) + 1e-4


def _decisions_equal(got, want):
    assert len(got) == len(want) and got
    for a, b in zip(got, want):
        assert (a.t, a.n_remaining, a.incumbent, a.chosen, a.swapped) == \
            (b.t, b.n_remaining, b.incumbent, b.chosen, b.swapped)
        assert a.predictions.keys() == b.predictions.keys()
        for k, v in a.predictions.items():
            assert v == pytest.approx(b.predictions[k], abs=1e-7), k


def _adaptive_spec(mod, *, device_sweep, P=16, technique="mFSC", every=4,
                   portfolio=None, calibrate=False, scenario=None):
    sc = scenario or faults.baseline(P)
    return mod.RunSpec(
        scheduling=mod.SchedulingSpec(technique=technique),
        cluster=mod.ClusterSpec.from_scenario(sc),
        execution=mod.ExecutionSpec(h=1e-4),
        adaptive=mod.AdaptiveSpec(
            enabled=True, device_sweep=device_sweep,
            decision_every_chunks=every, calibrate=calibrate,
            portfolio=portfolio if portfolio is not None
            else mod.DEVICE_PORTFOLIO))


@pytest.mark.parametrize("device_sweep", [True, False],
                         ids=["device_sweep", "scalar_sweep"])
def test_decisions_equal_reference(reference_devicesim, device_sweep):
    """mFSC over 16 workers and 1,024 unit tasks, the device portfolio,
    a decision every 4 reports: the port's controller makes the
    reference's decisions (4 of them), and the run ends the same."""
    tt = np.ones(1024)
    spec = _adaptive_spec(api, device_sweep=device_sweep)
    jspec = japi.RunSpec.from_dict(spec.to_dict())
    assert jspec.to_dict() == spec.to_dict()
    before = devicesim.batch_calls(CPU)
    got = api.simulate(spec, tt, sim_device=CPU)
    want = japi.simulate(jspec, tt)
    assert (devicesim.batch_calls(CPU) > before) == device_sweep
    _decisions_equal(got.adaptive_decisions, want.adaptive_decisions)
    assert len(got.adaptive_decisions) >= 3
    assert got.t_par == pytest.approx(want.t_par, abs=1e-9)
    assert (got.n_assignments, got.n_duplicates, got.wasted_tasks) == \
        (want.n_assignments, want.n_duplicates, want.wasted_tasks)


def test_device_sweep_on_and_off_decide_alike():
    """The flag changes cost, not behaviour, inside the port alone."""
    tt = np.ones(1024)
    on = api.simulate(_adaptive_spec(api, device_sweep=True), tt,
                      sim_device=CPU)
    off = api.simulate(_adaptive_spec(api, device_sweep=False), tt,
                       sim_device=CPU)
    _decisions_equal(on.adaptive_decisions, off.adaptive_decisions)


def test_perturbed_run_with_calibration_equals_reference():
    """The default portfolio (adaptive chunking, dup caps: the scalar
    forecasts) under a slowed node, forecasting from calibrated speeds:
    the same decisions and calibration evidence as the reference."""
    tt = task_times(512)
    sc = faults.pe_perturbation(8, node_size=4)
    spec = _adaptive_spec(api, device_sweep=False, P=8, technique="FAC",
                          every=32, portfolio=(), calibrate=True,
                          scenario=sc)
    got = api.simulate(spec, tt)
    want = japi.simulate(japi.RunSpec.from_dict(spec.to_dict()), tt)
    _decisions_equal(got.adaptive_decisions, want.adaptive_decisions)
    assert [d.calibration for d in got.adaptive_decisions] == \
        [d.calibration for d in want.adaptive_decisions]
    assert [d.to_dict() for d in got.adaptive_decisions] == \
        [d.to_dict() for d in want.adaptive_decisions]
    assert got.t_par == pytest.approx(want.t_par, abs=1e-9)


def test_run_adaptive_equals_reference():
    """``run_adaptive`` (FAC start, the five-technique portfolio, exact
    forecasts) under the mixed perturbation of tests/test_adaptive.py."""
    from repro.adaptive import AdaptiveConfig as JConfig
    from repro.adaptive import Candidate as JCandidate
    from repro.adaptive import run_adaptive as jrun_adaptive
    tt = task_times(256)
    kw = dict(decision_every_chunks=16, min_remaining=16,
              max_sim_tasks=None)
    sc = faults.pe_perturbation(8, node_size=4)
    res, ctrl = run_adaptive(tt, sc, initial="FAC", config=AdaptiveConfig(
        portfolio=PORTFOLIO, **kw))
    jres, jctrl = jrun_adaptive(
        tt, jfaults.pe_perturbation(8, node_size=4), initial="FAC",
        config=JConfig(portfolio=tuple(JCandidate(c.technique)
                                       for c in PORTFOLIO), **kw))
    assert not res.hang and res.n_finished == 256
    _decisions_equal(ctrl.decisions, jctrl.decisions)
    assert res.t_par == pytest.approx(jres.t_par, abs=1e-9)


def _engine(pkg, N, P, tt, technique="FAC"):
    d, r, e, s, f = pkg
    tech = d.make_technique(technique, N, P, seed=1)
    return e.Engine(r.RobustQueue(N, tech),
                    s.workers_from_scenario(f.pe_perturbation(P,
                                                              node_size=4)),
                    s.SimBackend(tt), h=1e-4)


class _CaptureAt:
    """Adaptive stub: snapshot the run after the k-th report."""

    def __init__(self, after, cap):
        self.after, self.cap = after, cap
        self.snap, self.n = None, 0

    def bind(self, engine):
        pass

    def on_report(self, engine, t):
        self.n += 1
        if self.snap is None and self.n >= self.after:
            self.snap = self.cap(engine, t)


def test_snapshot_and_sweep_equal_reference():
    """A snapshot taken after 20 reports, and the sweeps from it (exact
    and coarsened), equal the reference's field for field."""
    N, P = 300, 8
    tt = task_times(N)
    snaps = []
    for pkg, cap in (((dls, rdlb, engine, simulator, faults), capture),
                     ((jdls, jrdlb, jengine, jsim, jfaults), jcapture)):
        eng = _engine(pkg, N, P, tt)
        eng.adaptive = _CaptureAt(20, cap)
        eng.run()
        snaps.append(eng.adaptive.snap)
    a, b = snaps
    for f in ("t", "n_tasks", "n_finished", "outstanding_duplicates",
              "technique", "max_duplicates", "barrier_max_duplicates",
              "rdlb_enabled"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("unscheduled", "scheduled_unfinished", "remaining"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert [(w.wid, w.alive, w.speed, w.msg_latency, w.tasks_done,
             w.observed_rate) for w in a.workers] == \
        [(w.wid, w.alive, w.speed, w.msg_latency, w.tasks_done,
          w.observed_rate) for w in b.workers]
    from repro.adaptive import Candidate as JCandidate
    jport = tuple(JCandidate(c.technique) for c in PORTFOLIO)
    for cap in (None, 64):
        got = sweep(a, tt, PORTFOLIO, max_sim_tasks=cap)
        want = jsweep(b, tt, jport, max_sim_tasks=cap)
        assert [(c.label, t) for c, t in got] == \
            [(c.label, t) for c, t in want]


def test_spec_wiring():
    """``AdaptiveSpec.to_config`` gives the port's config, and
    ``api.build`` hangs a controller with the caller's ``sim_device`` on
    the engine."""
    spec = _adaptive_spec(api, device_sweep=True)
    cfg = spec.adaptive.to_config()
    assert isinstance(cfg, AdaptiveConfig)
    assert cfg.portfolio == api.DEVICE_PORTFOLIO and cfg.device_sweep
    assert cfg.decision_every_chunks == 4
    eng = api.build(spec, simulator.SimBackend(np.ones(64)), n_tasks=64,
                    sim_device=CPU)
    assert isinstance(eng.adaptive, AdaptiveController)
    assert eng.adaptive.sim_device == CPU
    assert api.AdaptiveSpec().to_config().portfolio == \
        api.DEFAULT_PORTFOLIO


def test_executors_accept_adaptive_policy():
    from repro_torch.data import batch_for_step
    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig
    from repro_torch.runtime import (RDLBServeExecutor, RDLBTrainExecutor,
                                     Request)

    cfg_m = ModelConfig(family="dense", n_layers=1, d_model=32, n_heads=2,
                        n_kv_heads=2, d_ff=64, vocab_size=64,
                        dtype="float32")
    model = build_model(cfg_m)
    params = model.init(0, device=CPU)

    acfg = AdaptiveConfig(portfolio=(Candidate("FAC"), Candidate("GSS")),
                          min_remaining=1, max_sim_tasks=None)
    ctrl = AdaptiveController(config=acfg)       # unit-cost tasks
    ex = RDLBTrainExecutor(model, spec=api.train_spec(n_workers=2,
                                                      n_tasks=4),
                           exact_accumulation=True, adaptive=ctrl)
    batch = batch_for_step(cfg_m, 0, 8, 16)
    res = ex.train_step(params, ex.opt.init(params), batch)
    assert not res.hung and math.isfinite(res.loss)
    assert len(ctrl.decisions) >= 1              # t=0 plan ran

    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, 64, size=4).astype(np.int32),
                    max_new_tokens=2) for i in range(6)]
    ctrl2 = AdaptiveController(config=acfg)
    sx = RDLBServeExecutor(model, params, spec=api.serve_spec(n_workers=2),
                           adaptive=ctrl2)
    stats = sx.serve(reqs)
    assert not stats.hung
    assert all(r.output is not None for r in reqs)
    assert len(ctrl2.decisions) >= 1


def test_decision_record_json_safe():
    rec = dataclasses.replace(
        api.simulate(_adaptive_spec(api, device_sweep=False), np.ones(256),
                     sim_device=CPU).adaptive_decisions[0],
        predictions={"SS": float("inf"), "FSC": 1.0})
    assert rec.to_dict()["predictions"] == {"SS": None, "FSC": 1.0}
