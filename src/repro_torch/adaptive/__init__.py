"""Adaptive scheduling: simulation-in-the-loop technique selection with
mid-run hot-swap.

The paper's rDLB picks one DLS technique and one duplication policy up
front and holds them for the whole run, even though no single technique
wins across its own scenarios (Figs. 4-5).  This subsystem closes the
SimAS/SiL loop on top of PR 1's unified engine:

    snapshot  (snapshot.py)  — capture mid-run state: unfinished tasks,
                               worker liveness/rates, duplicate slots;
    forecast  (forecaster.py)— resume the discrete-event simulator from
                               the snapshot for each (technique x rDLB
                               knobs) candidate and predict remaining
                               T_par;
    swap      (controller.py)— at decision points, hot-swap the live
                               RobustQueue's technique/knobs, preserving
                               exactly-once task accounting.

Because the simulator and the real executors share one engine loop, the
forecast exercises the *identical* scheduling path the live run takes —
with coarsening disabled it is exactly a fresh simulation of the
remainder.  ``Engine.run``/``run_threaded``, ``RDLBTrainExecutor``, and
``RDLBServeExecutor`` all accept an ``adaptive=`` policy.
"""

from repro_torch.adaptive.controller import (  # noqa: F401
    AdaptiveConfig, AdaptiveController, DecisionRecord,
)
from repro_torch.adaptive.forecaster import (  # noqa: F401
    Candidate, DEFAULT_PORTFOLIO, coarsen_times, forecast_candidate,
    remaining_times, run_static, scenario_from_snapshot, sweep,
)
from repro_torch.adaptive.snapshot import (  # noqa: F401
    EngineSnapshot, WorkerSnapshot, capture,
)


def run_adaptive(task_times, scenario, *, initial: str = "FAC",
                 config=None, h: float = 1e-4, seed: int = 0):
    """Convenience entry point: simulate one run under the adaptive policy.

    Starts from ``initial`` (the controller may immediately re-plan at
    t=0 when ``plan_at_start`` is on) and returns
    ``(SimResult, AdaptiveController)`` — decisions are on the
    controller and on ``EngineStats.adaptive_decisions``.
    """
    import numpy as np

    from repro_torch import api

    config = config or AdaptiveConfig()
    ctrl = AdaptiveController(task_times=task_times, config=config)
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique=initial, seed=seed,
                                      params=(("h", h),)),
        cluster=api.ClusterSpec.from_scenario(scenario),
        execution=api.ExecutionSpec(h=h))
    result = api.simulate(spec, np.asarray(task_times, dtype=float),
                          adaptive=ctrl)
    return result, ctrl
