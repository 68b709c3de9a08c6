"""One spec to run them all: the declarative RunSpec API.

    from repro_torch import api

    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="FAC"),
        robustness=api.RobustnessSpec(max_duplicates=2),
        cluster=api.ClusterSpec.from_scenario(scenario),
        execution=api.ExecutionSpec(mode="virtual", h=1e-4))
    result = api.simulate(spec, task_times)       # one call
    spec.save("scenario.json")                    # scenarios are data

Same spec, every driver: ``simulator.simulate(spec=...)``,
``RDLBTrainExecutor(model, spec=...)``, ``RDLBServeExecutor(model,
params, spec=...)``, the adaptive portfolio sweep, the benchmarks, and
``python -m repro_torch run --spec file.json``.
"""

from repro_torch.api.facade import (  # noqa: F401
    LEGACY_MSG, build, execute, make_scheduler, run, serve_spec, simulate,
    train_spec, warn_legacy,
)
from repro_torch.api.spec import (  # noqa: F401
    DEFAULT_PORTFOLIO, DEVICE_PORTFOLIO, SPEC_VERSION, AdaptiveSpec,
    Candidate, ClusterSpec,
    ExecutionSpec, RobustnessSpec, RunSpec, SchedulingSpec, WorkerSpec,
    spec_override,
)
