"""The port's copy of the scheduling stack (repro_torch.core/.api) against
the JAX package's (repro.core/.api): the same spec over the same task
times must give the same schedule, event for event.

Tolerance: none.  The copy runs the same float64 host arithmetic, so
every metric and every assignment must be identical.
"""

import math

import numpy as np
import pytest

from repro import api as japi
from repro.core import faults as jfaults
from repro.core import simulator as jsim
from repro_torch import api as tapi
from repro_torch.core import faults as tfaults
from repro_torch.core import simulator as tsim

N_TASKS = 384
TECHNIQUES = ("SS", "FAC", "GSS", "mFSC")


def _task_times() -> np.ndarray:
    rng = np.random.default_rng(7)
    return np.abs(rng.normal(0.01, 0.006, N_TASKS)) + 1e-4


def _scenario(name: str, faults_mod, t_exec: float):
    if name == "baseline":
        return faults_mod.baseline(8)
    if name == "fail_1":
        return faults_mod.failures(8, 1, t_exec_estimate=t_exec, seed=3)
    return faults_mod.pe_perturbation(32, node_size=16, node=1)


def _log(stats) -> list:
    return [(c.start, c.size, c.pe, c.seq, c.duplicate, c.origin_seq)
            for c in stats.assignment_log]


@pytest.mark.parametrize("rdlb_on", [True, False], ids=["rdlb", "no_rdlb"])
@pytest.mark.parametrize("scenario", ["baseline", "fail_1", "pe_perturb"])
@pytest.mark.parametrize("technique", TECHNIQUES)
def test_simulate_identical(technique, scenario, rdlb_on):
    tt = _task_times()
    t_exec = float(tt.sum()) / 8
    sc = _scenario(scenario, jfaults, t_exec)
    spec = japi.RunSpec(
        scheduling=japi.SchedulingSpec(technique=technique, seed=1),
        robustness=japi.RobustnessSpec(rdlb_enabled=rdlb_on),
        cluster=japi.ClusterSpec.from_scenario(sc),
        execution=japi.ExecutionSpec(h=1e-4))
    jspec = japi.RunSpec.from_dict(spec.to_dict())
    tspec = tapi.RunSpec.from_dict(spec.to_dict())
    assert tspec.to_dict() == jspec.to_dict()

    want = japi.simulate(jspec, tt)
    got = tapi.simulate(tspec, tt)
    for field in ("t_par", "n_finished", "n_assignments", "n_duplicates",
                  "wasted_tasks", "technique", "scenario", "rdlb"):
        a, b = getattr(want, field), getattr(got, field)
        assert a == b or (isinstance(a, float) and math.isinf(a)
                          and math.isinf(b)), field
    np.testing.assert_array_equal(got.pe_busy, want.pe_busy)

    # the assignment logs, through the engines the facades build
    jst = japi.run(jspec, japi.build(jspec, jsim.SimBackend(tt),
                                     n_tasks=N_TASKS))
    tst = tapi.run(tspec, tapi.build(tspec, tsim.SimBackend(tt),
                                     n_tasks=N_TASKS))
    assert _log(tst) == _log(jst)
    assert tst.by_worker == jst.by_worker
    assert tst.survivors == jst.survivors


@pytest.mark.parametrize("scenario", ["baseline", "fail_1", "pe_perturb"])
def test_fault_scenarios_identical(scenario):
    a = _scenario(scenario, jfaults, 2.0)
    b = _scenario(scenario, tfaults, 2.0)
    assert a.name == b.name
    assert [(p.speed, p.fail_time, p.msg_latency) for p in a.profiles] == \
        [(p.speed, p.fail_time, p.msg_latency) for p in b.profiles]


def test_unported_paths_raise():
    """Process mode needs a module of a later slice: it raises instead of
    running something else.  Adaptive re-planning and live metrics are
    ported: the engine carries a controller and a metrics hub."""
    base = tapi.RunSpec(cluster=tapi.ClusterSpec(n_workers=2), n_tasks=4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tapi.build(base.override("execution.mode", "process"),
                   tsim.SimBackend(np.ones(4)))
    from repro_torch.adaptive import AdaptiveController
    eng = tapi.build(base.override("adaptive.enabled", True),
                     tsim.SimBackend(np.ones(4)))
    assert isinstance(eng.adaptive, AdaptiveController)
    st = tapi.run(base.override("execution.metrics", True),
                  tapi.build(base.override("execution.metrics", True),
                             tsim.SimBackend(np.ones(4))))
    assert st.metrics["finished"] == 4
