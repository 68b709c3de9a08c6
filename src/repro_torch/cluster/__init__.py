"""Process-cluster runtime: real OS workers, real kills.

Port of ``repro.cluster``.  The paper validated rDLB by integrating into
an MPI DLS library and killing real ranks; this package is that
experiment's single-host counterpart.  Workers are child PROCESSES
speaking the engine's request/report protocol to an in-process master
over a length-prefixed socket transport, all driving the SAME
``RobustQueue`` — so the scheduling mathematics are shared with the
virtual-time twin while the perturbations are physical:
``fail_time``/``fail_after_tasks`` compile to SIGKILL, ``hang_time`` to
SIGSTOP, ``speed<1`` to a SIGSTOP/SIGCONT duty cycle, ``msg_latency`` to
transport delay (``repro_torch.cluster.chaos``).

Select it declaratively: ``ExecutionSpec(mode="process")`` (plus
``n_groups>1`` for the two-level group-master hierarchy); every driver —
``api.simulate``/``api.build``/``api.execute``, both executors, the
``python -m repro_torch`` CLI — routes here automatically.  Tasks that
compute on the card run in spawned interpreters, each with its own CUDA
context (``cluster.master``).
"""

from repro_torch.cluster.chaos import ChaosController, ChaosEvent  # noqa: F401
from repro_torch.cluster.master import (  # noqa: F401
    ClusterRun, factory_for_backend, group_master_main, reset_runs, runs,
)
from repro_torch.cluster.runners import (  # noqa: F401
    ServeTaskRunner, TrainTaskRunner,
)
from repro_torch.cluster.worker import (  # noqa: F401
    ChunkRunner, FnRunner, NullRunner, SleepRunner, kernel_info, task_device,
    worker_main,
)
