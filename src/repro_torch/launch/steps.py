"""Step builders on one device: train_step / prefill / decode per
architecture.

Port of ``repro.launch.steps``.  The reference builds each step with
explicit ``NamedSharding``s for every input over a TPU mesh; on one H100
everything lies on one device, so the port builds the steps alone, with
the partitioner's logical-axis rules kept for reporting
(``distributed.partitioner``) and ``set_partitioner`` around each step as
the reference has it.  These are the functions the dry run
(``launch.dryrun``) runs on ``meta`` tensors.  The rDLB runtime
(``runtime.executor``) drives the same value-and-grad at task
granularity.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.distributed.partitioner import (AxisRules, Partitioner,
                                                 make_rules, set_partitioner)
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (apply_updates, clip_by_global_norm,
                               make_optimizer)
from repro_torch.trips import trips


def make_partitioner(cfg: ModelConfig, mesh=None) -> Partitioner:
    """The reference's rule set for ``cfg.parallelism`` ("tp", "dp",
    "dp_data"), over ``mesh`` (``{axis: size}``; None: one device)."""
    mode = getattr(cfg, "parallelism", "tp")
    if mode == "dp":
        overrides = {
            "batch": ("pod", "data", "model"),
            "embed": ("data", "model"),
            "heads": None, "kv_heads": None, "mlp": None,
            "vocab": None, "expert": None, "cache_seq": "model",
        }
        return Partitioner(mesh, AxisRules(
            make_rules(fsdp=True, overrides=overrides)))
    if mode == "dp_data":
        overrides = {
            "heads": None, "kv_heads": None, "mlp": None,
            "vocab": None, "expert": None, "cache_seq": "model",
        }
        return Partitioner(mesh, AxisRules(
            make_rules(fsdp=True, overrides=overrides)))
    return Partitioner(mesh, AxisRules(make_rules(fsdp=cfg.fsdp)))


def _value_and_grad(model, params, batch: dict):
    from repro_torch.runtime.executor import value_and_grad
    return value_and_grad(lambda p, b: model.loss(p, b)[0], params, batch)


# =================================================================== train
@dataclasses.dataclass(frozen=True)
class TrainStep:
    model: Any
    step_fn: Any                 # (params, opt_state, batch) -> (...)
    opt: Any
    partitioner: Any

    def __call__(self, params, opt_state, batch: dict):
        return self.step_fn(params, opt_state, batch)


def make_train_step(cfg: ModelConfig, *, num_microbatches: int = 1,
                    optimizer: str = "adamw", lr: float = 1e-4,
                    accum_dtype=None, grad_clip: float = 1.0) -> TrainStep:
    """One optimizer step over ``num_microbatches`` microbatches (rows
    ``[i B/M, (i+1) B/M)`` of the batch, in order): their gradients
    summed in ``accum_dtype`` (float32; bfloat16 for deepseek-v3, as the
    reference) and averaged, clipped to ``grad_clip`` in global norm,
    then the optimizer's update.  Returns (params, opt_state,
    {"loss", "grad_norm"})."""
    model = build_model(cfg)
    opt = make_optimizer(optimizer, lr=lr)
    part = make_partitioner(cfg)
    M = num_microbatches
    acc_dt = accum_dtype or (torch.bfloat16 if cfg.name.startswith(
        "deepseek-v3") else torch.float32)

    def step_fn(params, opt_state, batch):
        with set_partitioner(part):
            if M == 1:
                loss, grads = _value_and_grad(model, params, batch)
            else:
                rows = batch["tokens"].shape[0] // M
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=acc_dt, device=p.device), params)
                loss = torch.zeros((), dtype=torch.float32,
                                   device=batch["tokens"].device)
                for i in trips(M):
                    ub = {k: v[i * rows:(i + 1) * rows]
                          for k, v in batch.items()}
                    l, g = _value_and_grad(model, params, ub)
                    for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                        a.add_(b.to(acc_dt))
                    loss = loss + l
                grads = tree_map(lambda g: g / M, grads)
                loss = loss / M
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return TrainStep(model, step_fn, opt, part)


# =================================================================== serve
@dataclasses.dataclass(frozen=True)
class ServeStep:
    model: Any
    prefill_fn: Any              # (params, batch) -> last-token logits
    decode_fn: Any               # (params, cache, tokens, pos) -> (tok, cache)
    partitioner: Any


def make_serve_step(cfg: ModelConfig) -> ServeStep:
    """``prefill_fn(params, batch)`` -> the last position's logits
    (B, 1, V) of a full-sequence forward; ``decode_fn(params, cache,
    tokens (B, 1), pos)`` -> (greedy next tokens (B, 1) int32, cache),
    ``pos`` an int."""
    model = build_model(cfg)
    part = make_partitioner(cfg)

    def prefill_fn(params, batch):
        with set_partitioner(part), torch.inference_mode():
            tokens = batch["tokens"]
            if cfg.family == "encdec":
                return model.forward(params, tokens, batch["frames"],
                                     last_only=True)
            if cfg.family == "hybrid":
                return model.forward(params, tokens, last_only=True)
            if cfg.family == "rwkv":
                return model.forward(params, tokens, last_only=True)[0]
            return model.forward(params, tokens, batch.get("patches"),
                                 last_only=True)[0]

    def decode_fn(params, cache, tokens, pos: int):
        with set_partitioner(part), torch.inference_mode():
            logits, cache = model.decode_step(params, cache, tokens,
                                              int(pos))
            next_tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        return next_tok.to(torch.int32), cache

    return ServeStep(model, prefill_fn, decode_fn, part)


def abstract_state(step: TrainStep, *, device="meta"
                   ) -> tuple[Any, Any]:
    """(params, optimizer state) of ``step``'s model on ``device`` —
    abstract on ``meta``: nothing drawn, nothing allocated."""
    params = step.model.init(0, device=device)
    return params, step.opt.init(params)


def state_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

