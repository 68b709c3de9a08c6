"""Elastic worker-set management (beyond-paper: the paper terminates after
the loop completes; we keep TRAINING through failures).  Port of
``repro.runtime.elastic``.

After a step that lost workers, the coordinator:
  1. shrinks the worker set to the survivors (the rDLB queue already
     guaranteed the step completed);
  2. re-balances the task count so chunk shapes stay static.

The reference's ``reshard_tree`` (re-sharding params onto a rebuilt JAX
mesh) is jax-sharding only and has no counterpart here: on one card the
workers are threads that share the parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.runtime.executor import RDLBTrainExecutor, WorkerState


@dataclasses.dataclass
class ElasticState:
    generation: int = 0
    history: list = dataclasses.field(default_factory=list)


def shrink_to_survivors(executor: RDLBTrainExecutor,
                        state: Optional[ElasticState] = None
                        ) -> ElasticState:
    """Drop dead workers; renumber; KEEP the survivors' learned state.

    Rebuilding fresh ``WorkerState`` for survivors would discard the
    observed speed and execution history that adaptive policies and
    AWF-style weight learning prime from — each survivor carries its
    stats across the renumbering (the old->new wid map is recorded in
    the generation history).
    """
    state = state or ElasticState()
    survivors = [w for w in executor.workers if w.alive]
    if len(survivors) == len(executor.workers):
        return state
    state.generation += 1
    state.history.append({
        "generation": state.generation,
        "survivors": [w.wid for w in survivors],
        "renumbering": {w.wid: i for i, w in enumerate(survivors)},
    })
    if not survivors:
        executor.n_workers = 1
        executor.workers = [WorkerState(0)]
        return state
    executor.n_workers = len(survivors)
    executor.workers = [dataclasses.replace(w, wid=i)
                        for i, w in enumerate(survivors)]
    return state


def rebalance_tasks(n_tasks: int, n_workers: int, global_batch: int) -> int:
    """Keep tasks divisible into the batch and >= workers (static shapes).

    Clamped to the batch size BEFORE the divisor search: with more
    workers than batch rows the best available is one row per task
    (n == global_batch); the old unclamped search
    (``while global_batch % n: n += 1``) never terminated there.
    """
    if global_batch <= 0:
        raise ValueError(f"global_batch must be positive, "
                         f"got {global_batch}")
    n = min(max(n_workers, n_tasks, 1), global_batch)
    while global_batch % n:
        n += 1
    return n
