"""rDLB training executor: the paper's technique as a PyTorch runtime
feature.  Port of ``repro.runtime.executor``.

One global training step = N independent TASKS (grad-accumulation
microbatches, each a slice of the global batch).  Tasks are
self-scheduled to WORKERS (data-parallel workers; threads sharing the
card in threaded mode) through the unified engine
(``repro_torch.core.engine``); this executor only supplies a
``TrainBackend`` (microbatch gradients, exactly-once reduction):

  * a free worker requests work; the DLS technique sizes its chunk of tasks;
  * with rDLB, once every task is assigned, idle workers receive DUPLICATES
    of in-flight tasks (oldest first) — no failure detection anywhere;
  * gradient accumulation is EXACTLY-ONCE BY TASK ID: a duplicate's result
    is discarded if the original already landed (and vice versa).  The data
    pipeline is content-addressed (``repro_torch.data``) and every kernel
    on the path sums in a fixed order, so a re-executed task computes
    bit-identical gradients and which copy wins is irrelevant;
  * fail-stop workers simply never report; their in-flight tasks are
    re-issued to survivors.  Up to W-1 worker losses are tolerated within
    a step (the paper's P-1 claim, at chunk granularity);
  * without rDLB, a failure turns the step into the paper's Fig. 1b hang —
    surfaced as ``StepResult.hung`` instead of an infinite wait.

Each task differentiates the loss with ``torch.autograd.grad`` with
respect to its own detached view of the parameters (no copy), never with
``loss.backward()``: worker threads and duplicates would race on shared
``.grad`` buffers.  Parameters and optimizer state are trees of tensors
(``models.common.tree_map``); a step returns new ones.

Configuration is a declarative :class:`repro_torch.api.RunSpec`
(``RDLBTrainExecutor(model, spec=spec)``); the legacy keyword vocabulary
(``technique=``, ``rdlb_enabled=``, ``FaultPlan`` …) still works as a
shim that builds the equivalent spec under a ``DeprecationWarning``.
Process mode (``repro.cluster``) is not ported yet: ROADMAP.md queue A,
item A8.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import api
from repro_torch.data import as_tensors, chunk_batch
from repro_torch.models.common import (ParamTree, first_tensor, tree_leaves,
                                       tree_map, tree_unflatten)
from repro_torch.optim import (apply_updates, clip_by_global_norm,
                               make_optimizer)
from repro_torch.runtime.backends import TrainBackend

_UNSET = object()


@dataclasses.dataclass
class WorkerState:
    wid: int
    alive: bool = True
    speed: float = 1.0                    # <1.0 = straggler
    fail_after_tasks: Optional[int] = None  # fail-stop after N task execs
    tasks_done: int = 0                   # executed (incl. wasted)
    credit: float = 0.0
    # The spec-declared WorkerSpec this state was materialized from —
    # carries perturbations the live fields above don't track
    # (fail_time, msg_latency, sleep_per_task) back into each step's
    # ClusterSpec.  None = nominal.
    profile: Optional[api.WorkerSpec] = None


@dataclasses.dataclass
class FaultPlan:
    """Per-step fault/perturbation injection (worker id -> behaviour).

    Legacy vocabulary: ``ClusterSpec.from_fault_plan`` absorbs it into
    the unified WorkerSpec fields (``slow`` maps to ``speed``,
    ``fail_after`` to ``fail_after_tasks``).
    """
    fail_after: dict = dataclasses.field(default_factory=dict)
    slow: dict = dataclasses.field(default_factory=dict)

    def apply(self, workers: list[WorkerState]) -> None:
        for w in workers:
            if w.wid in self.fail_after:
                w.fail_after_tasks = self.fail_after[w.wid]
            if w.wid in self.slow:
                w.speed = self.slow[w.wid]


@dataclasses.dataclass
class StepResult:
    params: Any
    opt_state: Any
    loss: float
    hung: bool
    n_tasks: int
    n_duplicates: int
    wasted_tasks: int
    tasks_by_worker: dict
    survivors: list


def value_and_grad(loss_fn: Callable, params, batch: dict):
    """(loss, grads) of ``loss_fn(params, batch)`` -> scalar, with
    ``torch.autograd.grad`` over a trainable view of ``params`` that
    shares their storage; grads have ``params``' tree structure (nested
    dicts and lists) and dtypes, zeros for a leaf the loss does not
    reach."""
    tree = ParamTree(tree_map(torch.Tensor.detach, params), trainable=True)
    leaves = tree_leaves(tree)
    with torch.enable_grad():
        loss = loss_fn(tree, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), tree_unflatten(tree, grads)


class RDLBTrainExecutor:
    """Drives model training with DLS + rDLB task scheduling.

    Parameters
    ----------
    model:       a repro_torch model with ``.loss(params, batch)``.
    spec:        a :class:`repro_torch.api.RunSpec` — scheduling technique,
                 rDLB knobs, cluster (worker count + perturbations),
                 execution mode (``"threaded"`` = real OS threads whose
                 duplicates race in wall-clock time), adaptive policy.
                 ``spec.n_tasks`` is the grad-accum microbatches per
                 global step.
    optimizer/lr/grad_clip/loss_fn: training-side knobs (not scheduling
                 — deliberately outside the spec).
    exact_accumulation: store per-task grads and reduce in task order —
                 bit-identical results regardless of schedule (used by the
                 equality tests); False accumulates in arrival order.
    adaptive:    optional live adaptive policy object
                 (repro_torch.adaptive.AdaptiveController), overriding
                 ``spec.adaptive``.

    The model runs where the parameters lie; a step moves each task's
    rows of the batch (numpy arrays or tensors) there.

    Legacy keywords (deprecated): ``n_workers``, ``n_tasks``,
    ``technique``, ``rdlb_enabled``, ``max_duplicates``, ``concurrent``
    build the equivalent spec and warn.
    """

    def __init__(self, model, *, spec: Optional[api.RunSpec] = None,
                 n_workers: Any = _UNSET, n_tasks: Any = _UNSET,
                 technique: Any = _UNSET, rdlb_enabled: Any = _UNSET,
                 optimizer: str = "adamw", lr: float = 1e-3,
                 grad_clip: float = 1.0, exact_accumulation: bool = False,
                 max_duplicates: Any = _UNSET,
                 loss_fn: Optional[Callable] = None,
                 concurrent: Any = _UNSET,
                 adaptive: Optional[Any] = None):
        legacy = {k: v for k, v in dict(
            n_workers=n_workers, n_tasks=n_tasks, technique=technique,
            rdlb_enabled=rdlb_enabled, max_duplicates=max_duplicates,
            concurrent=concurrent).items() if v is not _UNSET}
        if spec is None:
            if legacy:
                api.warn_legacy(f"RDLBTrainExecutor({', '.join(legacy)})")
            spec = api.train_spec(
                technique=legacy.get("technique", "FAC"),
                n_workers=legacy.get("n_workers", 4),
                n_tasks=legacy.get("n_tasks", 8),
                rdlb_enabled=legacy.get("rdlb_enabled", True),
                max_duplicates=legacy.get("max_duplicates"),
                threaded=bool(legacy.get("concurrent")))
        elif legacy:
            raise TypeError("pass spec= OR legacy keywords, not both: "
                            f"{sorted(legacy)}")
        if spec.n_tasks is None:
            raise ValueError("training needs spec.n_tasks (microbatches "
                             "per global step)")
        self.spec = spec
        self.n_workers = spec.cluster.n_workers
        self.n_tasks = spec.n_tasks
        self.model = model
        self.exact_accumulation = exact_accumulation
        self.adaptive = adaptive
        self.opt = make_optimizer(optimizer, lr=lr)
        self.grad_clip = grad_clip
        self._loss_fn = loss_fn or (lambda p, b: model.loss(p, b)[0])
        self.reset_workers()

    # ------------------------------------------------------------- helpers
    def reset_workers(self) -> None:
        """(Re)materialize live worker state from the spec's cluster."""
        self.workers = [
            WorkerState(wid, alive=w.alive, speed=w.speed,
                        fail_after_tasks=w.fail_after_tasks, profile=w)
            for wid, w in enumerate(self.spec.cluster.worker_specs())]

    @property
    def alive_workers(self) -> list[WorkerState]:
        return [w for w in self.workers if w.alive]

    def _task_batch(self, batch: dict, task_id: int, device) -> dict:
        B = batch["tokens"].shape[0]
        rows = B // self.n_tasks
        return as_tensors(chunk_batch(batch, task_id * rows, rows), device)

    # ---------------------------------------------------------------- step
    def train_step(self, params, opt_state, batch: dict, *,
                   fault_plan: Optional[FaultPlan] = None,
                   max_rounds: Optional[int] = None) -> StepResult:
        B = batch["tokens"].shape[0]
        assert B % self.n_tasks == 0, (B, self.n_tasks)
        if fault_plan:
            api.warn_legacy("train_step(fault_plan=...); declare the "
                            "perturbations on spec.cluster")
            fault_plan.apply(self.workers)
        # The step's cluster is the LIVE worker state (liveness and
        # speeds learned/injected so far), through the one vocabulary.
        cluster = api.ClusterSpec.from_worker_states(
            self.workers, name=self.spec.cluster.name or "train")
        spec = self.spec.replace(cluster=cluster, n_tasks=self.n_tasks)
        if max_rounds is not None:
            spec = spec.override("execution.horizon", float(max_rounds))
        if spec.execution.mode == "process":
            raise NotImplementedError(
                "training with mode='process' (repro.cluster."
                "TrainTaskRunner) is not ported to repro_torch yet: "
                "ROADMAP.md queue A, item A8")
        dev = first_tensor(params).device
        backend = TrainBackend(
            lambda t: value_and_grad(self._loss_fn, params,
                                     self._task_batch(batch, t, dev)),
            exact_accumulation=self.exact_accumulation)
        eng = api.build(spec, backend, n_tasks=self.n_tasks,
                        adaptive=self.adaptive)
        for ew, w in zip(eng.workers, self.workers):
            ew.tasks_done = w.tasks_done     # count-based fail-stop state
        stats = api.run(spec, eng)
        for w, ew in zip(self.workers, eng.workers):  # liveness flows back
            w.alive, w.tasks_done = ew.alive, ew.tasks_done

        queue = eng.queue
        grad_acc = backend.reduced()
        backend.per_task.clear()      # free them before the optimizer runs
        if stats.hung or grad_acc is None:
            return StepResult(params, opt_state, float("nan"), True,
                              self.n_tasks, queue.n_duplicates,
                              queue.wasted_tasks, dict(stats.by_worker),
                              [w.wid for w in self.alive_workers])

        grads = tree_map(lambda g: g / self.n_tasks, grad_acc)
        grads, _ = clip_by_global_norm(grads, self.grad_clip)
        updates, opt_state = self.opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return StepResult(params, opt_state,
                          backend.loss_sum / max(1, backend.n_done),
                          False, self.n_tasks, queue.n_duplicates,
                          queue.wasted_tasks, dict(stats.by_worker),
                          [w.wid for w in self.alive_workers])
