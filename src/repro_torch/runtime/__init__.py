from repro_torch.runtime.backends import (  # noqa: F401
    FnBackend, ServeBackend, TrainBackend,
)
from repro_torch.runtime.elastic import (  # noqa: F401
    ElasticState, rebalance_tasks, shrink_to_survivors,
)
from repro_torch.runtime.executor import (  # noqa: F401
    FaultPlan, RDLBTrainExecutor, StepResult, WorkerState,
)
from repro_torch.runtime.serve_executor import (  # noqa: F401
    RDLBServeExecutor, Request, ServeStats,
)
