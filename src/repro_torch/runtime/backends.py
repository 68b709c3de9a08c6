"""Worker backends for the unified self-scheduling engine.

The engine (repro_torch.core.engine) owns the master-worker loop — request,
liveness, barrier polling, hang surfacing, metrics.  A backend only
defines what a chunk of tasks IS:

  * :class:`FnBackend`      — run a Python callable per task (parity tests,
                              run_to_completion-style draining of real work);
  * :class:`ServeBackend`   — inference requests, decoded per-request or as
                              padded batches, first-completion-wins.

``TrainBackend`` of ``repro.runtime.backends`` comes with the training
slice of the port (ROADMAP.md queue A, item A5).

Backends never talk to the queue; ``commit`` receives the task ids its
report newly finished, so a duplicate's payload is applied only for tasks
it won.  ``commit`` runs under the engine's commit lock in threaded mode.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np

from repro_torch.core.engine import WorkerBackend
from repro_torch.core.rdlb import Chunk


class FnBackend(WorkerBackend):
    """Execute ``task_fn(task_id)`` per task; optional nominal costs.

    With ``task_times`` the scheduling timeline is identical to the
    simulator backend over the same costs — the sim/exec parity seam.
    """

    def __init__(self, task_fn: Optional[Callable[[int], Any]] = None,
                 task_times: Optional[Sequence[float]] = None) -> None:
        self.task_fn = task_fn
        self._ctime = (None if task_times is None else
                       np.cumsum(np.concatenate([[0.0], task_times])))
        self.results: dict[int, Any] = {}     # exactly-once, by task id

    def execute(self, chunk: Chunk, wid: int) -> Any:
        if self.task_fn is None:
            return None
        return {t: self.task_fn(t) for t in chunk.tasks()}

    def cost(self, chunk: Chunk, wid: int) -> float:
        if self._ctime is None:
            return float(chunk.size)
        return float(self._ctime[chunk.stop] - self._ctime[chunk.start])

    def commit(self, chunk: Chunk, wid: int, payload: Any,
               newly: list[int]) -> None:
        if payload is None:
            return
        for t in newly:
            self.results[t] = payload[t]


class ServeBackend(WorkerBackend):
    """Inference requests; first-completion-wins output commit.

    ``generate_fn(requests) -> {rid: tokens}`` decodes a chunk's requests
    (per-request loop or one padded batch — the engine doesn't care).
    Greedy decode is deterministic, so duplicates are interchangeable and
    whichever report lands first fixes the output.
    """

    def __init__(self, requests: Sequence,
                 generate_fn: Callable[[list], dict]) -> None:
        self.requests = requests
        self.generate_fn = generate_fn

    def execute(self, chunk: Chunk, wid: int) -> Any:
        return self.generate_fn([self.requests[r] for r in chunk.tasks()])

    def commit(self, chunk: Chunk, wid: int, payload: Any,
               newly: list[int]) -> None:
        for rid in newly:
            req = self.requests[rid]
            req.output = payload[rid]
            req.completed_by = wid
            req.duplicated = chunk.duplicate
