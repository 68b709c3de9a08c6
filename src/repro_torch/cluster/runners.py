"""Picklable runners that rebuild the real compute in a child process.

Port of ``repro.cluster.runners``.  The training/serving executors'
backends hold closures over models and card-resident weights, which
cannot cross a process boundary.  These runners carry the *recipe*
instead — a ``ModelConfig``, the weights as host tensors, the batch or
the requests as numpy arrays — and rebuild the model inside the worker
process (``setup()`` runs there, after the spawn, so the child pays the
torch import and the weights' copy to its device, not the master at
pickle time).

They declare ``start_method = "spawn"``: on the card each child needs a
CUDA context of its own, which a forked child of a process holding one
cannot create; on the CPU a spawned child also starts with a fresh
intra-op thread pool, which it keeps to one thread so P children do not
oversubscribe the host's cores.

Weights across the boundary: numpy has no bfloat16, so the weights
travel as CPU tensors.  The master's ``ClusterRun`` calls ``ship(dir)``
before spawning: the weights go into one ``torch.save`` file in the
run's directory (removed at teardown), and every child loads it with
``mmap=True`` and copies the leaves to its device.  olmo-1b is about
1.18 B parameters, 2.35 GB in bfloat16: one host file, and one copy on
the card for each child beside the master's.

Gradients across the boundary: a training task returns its loss and
every gradient leaf, as CPU tensors in the parameters' dtype, over the
socket; the master's ``TrainBackend.commit`` accumulates them
exactly-once by task id, in float32, in a fixed order with exact
accumulation.  A task's payload is the parameters' size (olmo-1b at full
depth: 2.35 GB, above the transport's 1 GiB frame cap), so process-mode
training on the card runs at a depth whose gradients fit one frame.

Numerics parity: the child computes with the same model code, weights
and greedy decode as the in-process paths, so duplicates remain
interchangeable (first-completion-wins) and gradients are the same
per-task values the threaded executor would commit.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.common import first_tensor, tree_map

WEIGHTS_FILE = "weights.pt"


def host_tree(params) -> Any:
    """``params`` (a ParamTree or nested dicts/lists of tensors) as
    nested dicts/lists of detached CPU tensors."""
    return tree_map(lambda t: t.detach().cpu(), params)


def _ship(runner, directory: str):
    path = os.path.join(directory, WEIGHTS_FILE)
    torch.save(runner.params, path)
    return dataclasses.replace(runner, params=None, params_path=path)


def _weights_on(runner, dev: torch.device):
    from repro_torch.models.common import ParamTree
    tree = torch.load(runner.params_path, mmap=True, weights_only=True)
    return ParamTree(tree_map(lambda t: t.to(dev), tree))


def _child_device(name: str) -> torch.device:
    from repro_torch.device import resolve
    dev = resolve(name)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    return dev


@dataclasses.dataclass
class TrainTaskRunner:
    """Per-task microbatch gradients, recomputed in the worker process.

    ``params`` is a host tree (:func:`host_tree`), ``batch`` a dict of
    numpy arrays.  Payload per task: ``(loss, grads)`` with CPU-tensor
    grads in the parameters' dtype, which the master-side
    ``TrainBackend.commit`` accumulates exactly-once by task id."""
    cfg: Any                     # repro_torch.models.config.ModelConfig
    params: Any                  # host tree; None once shipped
    batch: Any                   # dict of numpy arrays
    n_tasks: int
    device: str = "cuda"
    params_path: Optional[str] = None

    start_method = "spawn"

    @classmethod
    def from_executor(cls, model, params, batch: dict, n_tasks: int
                      ) -> "TrainTaskRunner":
        batch = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                     else np.asarray(v)) for k, v in batch.items()}
        return cls(model.cfg, host_tree(params), batch, n_tasks,
                   device=first_tensor(params).device.type)

    def ship(self, directory: str) -> "TrainTaskRunner":
        return _ship(self, directory)

    def setup(self) -> None:
        from repro_torch.models import build_model
        self._dev = _child_device(self.device)
        model = build_model(self.cfg)
        self._params = _weights_on(self, self._dev)
        self._loss = lambda p, b: model.loss(p, b)[0]

    def __call__(self, tasks: Sequence[int]) -> dict:
        from repro_torch.data import as_tensors, chunk_batch
        from repro_torch.runtime.executor import value_and_grad
        rows = self.batch["tokens"].shape[0] // self.n_tasks
        out = {}
        for t in tasks:
            loss, grads = value_and_grad(
                self._loss, self._params,
                as_tensors(chunk_batch(self.batch, t * rows, rows),
                           self._dev))
            out[t] = (float(loss), host_tree(grads))
        return out


@dataclasses.dataclass
class ServeTaskRunner:
    """Greedy request decoding, recomputed in the worker process.

    ``requests`` is the picklable projection of the serve batch:
    ``(rid, prompt np.int32, max_new_tokens)`` triples indexed by task
    id.  Decoding goes through the SAME path as the in-process executor
    (``repro_torch.runtime.serve_executor.decode_request_groups``) with
    its ``batch_decode`` and ``fused_decode`` flags, so outputs are
    token-identical across execution modes."""
    cfg: Any                     # repro_torch.models.config.ModelConfig
    params: Any                  # host tree; None once shipped
    requests: Any                # list of (rid, prompt, max_new)
    device: str = "cuda"
    params_path: Optional[str] = None
    batch_decode: bool = True
    fused_decode: bool = True    # device-resident prefill + decode loop

    start_method = "spawn"

    @classmethod
    def from_model(cls, model, params, requests, *,
                   batch_decode: bool = True,
                   fused_decode: bool = True) -> "ServeTaskRunner":
        cfg = getattr(model, "cfg", None)
        if cfg is None:
            raise ValueError("process mode needs a model with .cfg "
                             "(rebuildable via models.build_model)")
        return cls(cfg, host_tree(params),
                   [(r.rid, np.asarray(r.prompt, dtype=np.int32),
                     int(r.max_new_tokens)) for r in requests],
                   device=first_tensor(params).device.type,
                   batch_decode=batch_decode, fused_decode=fused_decode)

    def ship(self, directory: str) -> "ServeTaskRunner":
        return _ship(self, directory)

    def setup(self) -> None:
        from repro_torch.models import build_model
        from repro_torch.runtime.serve_executor import (FusedGenerator,
                                                        Request)
        dev = _child_device(self.device)
        self._model = build_model(self.cfg)
        self._gen = FusedGenerator(self._model) if self.fused_decode \
            else None
        self._params = _weights_on(self, dev)
        self._reqs = {rid: Request(rid, prompt, max_new)
                      for rid, prompt, max_new in self.requests}

    def __call__(self, tasks: Sequence[int]) -> dict:
        from repro_torch.runtime.serve_executor import decode_request_groups
        return decode_request_groups(
            self._model, self._params, self._model.decode_step,
            [self._reqs[t] for t in tasks], batch_decode=self.batch_decode,
            generator=self._gen)
