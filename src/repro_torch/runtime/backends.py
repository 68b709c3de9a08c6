"""Worker backends for the unified self-scheduling engine.

The engine (repro_torch.core.engine) owns the master-worker loop — request,
liveness, barrier polling, hang surfacing, metrics.  A backend only
defines what a chunk of tasks IS:

  * :class:`FnBackend`      — run a Python callable per task (parity tests,
                              run_to_completion-style draining of real work);
  * :class:`TrainBackend`   — grad-accumulation microbatches with
                              exactly-once-by-task-id reduction;
  * :class:`ServeBackend`   — inference requests, decoded per-request or as
                              padded batches, first-completion-wins.

Backends never talk to the queue; ``commit`` receives the task ids its
report newly finished, so a duplicate's payload is applied only for tasks
it won.  ``commit`` runs under the engine's commit lock in threaded mode.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import WorkerBackend
from repro_torch.core.rdlb import Chunk
from repro_torch.models.common import tree_leaves, tree_map


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


class TrainBackend(WorkerBackend):
    """Grad-accum microbatches; exactly-once gradient reduction.

    ``grad_fn(task_id) -> (loss, grads)`` computes one microbatch (grads:
    a tree of tensors).  A duplicate executes (wasted work, as in the
    paper) but ``commit`` only accumulates tasks its report won, so k
    fail-stop workers change nothing about the computed update.

    exact_accumulation: store per-task grads and reduce in task order at
    the end, in float32 — bit-identical results regardless of schedule.
    Otherwise accumulate in report-arrival order (cheaper; order is
    deterministic in virtual-time mode, racy in threaded mode).
    """

    def __init__(self, grad_fn: Callable[[int], tuple], *,
                 exact_accumulation: bool = False) -> None:
        self.grad_fn = grad_fn
        self.exact = exact_accumulation
        self.per_task: dict[int, Any] = {}
        self.grad_acc = None
        self.loss_sum = 0.0
        self.n_done = 0

    def execute(self, chunk: Chunk, wid: int) -> Any:
        return {t: self.grad_fn(t) for t in chunk.tasks()}

    def commit(self, chunk: Chunk, wid: int, payload: Any,
               newly: list[int]) -> None:
        for t in newly:
            loss, grads = payload[t]
            self.loss_sum += float(loss)
            self.n_done += 1
            if self.exact:
                self.per_task[t] = grads
            else:
                self.grad_acc = _add(self.grad_acc, grads)

    def reduced(self) -> Any:
        """Final accumulated gradients, float32 (fixed task order when
        exact)."""
        if not self.exact:
            return self.grad_acc
        acc = None
        for t in sorted(self.per_task):
            acc = _add(acc, self.per_task[t])
        return acc


def _add(acc, grads):
    """acc + grads in float32, in place into ``acc`` after the first."""
    if acc is None:
        return tree_map(lambda g: g.to(torch.float32, copy=True), grads)
    for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
        a.add_(g)
    return acc


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
