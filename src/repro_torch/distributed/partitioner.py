"""Logical-axis partitioner on one device: the rules without the mesh.

Port of ``repro.distributed.partitioner``.  Every parameter and
activation of the reference is annotated with *logical* axis names
("batch", "embed", "heads", "expert", ...), and a rule set maps each
name to a physical mesh axis (or ``None`` = replicated).  On one H100
there is no mesh to shard over: sharding reduces to placing every tensor
on the one card.  So the port keeps the mapping itself — ``make_rules``
and ``AxisRules.spec``, pure Python, equal to the reference's — and
resolves it against a mesh given as ``{axis name: size}`` (the
reference's ``mesh.shape``) for reporting what a multi-device layout
would do; constraints (:meth:`Partitioner.constrain`,
:func:`logical_constraint`) are the identity.

Rule sets
---------
``BASE_RULES``        TP over "model" (heads / mlp / vocab / experts), DP
                      over ("pod", "data") for the batch.
``make_rules(fsdp)``  base + "embed" -> "data" (ZeRO-3 style).
``make_rules(seq_shard)`` base + activation sequence axis -> "model".

A rule only applies when the dimension is divisible by the mesh-axis
size — otherwise the dim falls back to replicated.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Mapping, Optional, Sequence, Union

import torch

AxisName = Optional[str]
LogicalAxes = Sequence[AxisName]
RuleValue = Union[None, str, tuple]


# --------------------------------------------------------------------- rules
BASE_RULES: dict[str, RuleValue] = {
    "batch": ("pod", "data"),       # data parallelism across pods + data axis
    "seq": None,
    "cache_seq": "model",           # decode KV-cache length: sequence-
                                    # sharded cache (32k x many layers does
                                    # not fit per-chip replicated; partial
                                    # attention + reduction is XLA-native)
    "embed": None,                  # residual stream (fsdp_rules shards it)
    "mlp": "model",                 # FFN hidden
    "heads": "model",               # attention heads (q)
    "kv_heads": "model",            # attention kv heads (GQA)
    "vocab": "model",               # embedding / logits vocab
    "expert": "model",              # MoE expert parallelism
    "expert_mlp": None,             # per-expert FFN hidden (EP already shards)
    "kv_lora": None,                # MLA compressed dims
    "q_lora": None,
    "layers": None,                 # stacked scan-over-layers axis
    "conv": None,
    "state": None,                  # SSM / RWKV state dims
    "act_embed": None,              # activation residual dim (act. constraint)
}


def make_rules(*, fsdp: bool = False, seq_shard: bool = False,
               expert_mlp_shard: bool = False,
               overrides: Optional[Mapping[str, RuleValue]] = None
               ) -> dict[str, RuleValue]:
    rules = dict(BASE_RULES)
    if fsdp:
        rules["embed"] = "data"          # ZeRO-3 parameter sharding
    if seq_shard:
        rules["seq"] = "model"           # SP on activations between blocks
        rules["cache_seq"] = "data"
    if expert_mlp_shard:
        rules["expert_mlp"] = "model"
    if overrides:
        rules.update(overrides)
    return rules


MeshShape = Mapping[str, int]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    rules: Mapping[str, RuleValue]

    def spec(self, logical_axes: LogicalAxes,
             shape: Optional[Sequence[int]] = None,
             mesh: Optional[MeshShape] = None) -> tuple:
        """Resolve logical axes to the entries of a PartitionSpec (a
        tuple, trailing replicated entries dropped, as ``P(*parts)``
        keeps them).

        When ``shape``+``mesh`` are given, a mapping is dropped (->
        replicated) if the dim is not divisible by the mesh-axes size,
        and a mesh axis is never used twice in one spec.
        """
        parts = []
        used: set[str] = set()
        for i, name in enumerate(logical_axes):
            rule = self.rules.get(name) if name is not None else None
            if rule is None:
                parts.append(None)
                continue
            axes = (rule,) if isinstance(rule, str) else tuple(rule)
            if mesh is not None:
                axes = tuple(a for a in axes if a in mesh)
            axes = tuple(a for a in axes if a not in used)
            if not axes:
                parts.append(None)
                continue
            if shape is not None and mesh is not None:
                total = 1
                for a in axes:
                    total *= mesh[a]
                if total == 0 or shape[i] % total != 0:
                    parts.append(None)
                    continue
            used.update(axes)
            parts.append(axes[0] if len(axes) == 1 else axes)
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)


# ---------------------------------------------------------------- partitioner
@dataclasses.dataclass
class Partitioner:
    """Binds a mesh shape (None: one device) and a rule set."""
    mesh: Optional[MeshShape]
    rules: AxisRules

    def spec(self, logical_axes: LogicalAxes,
             shape: Optional[Sequence[int]] = None) -> tuple:
        return self.rules.spec(logical_axes, shape, self.mesh)

    def constrain(self, x: torch.Tensor,
                  logical_axes: LogicalAxes) -> torch.Tensor:
        """The reference's activation constraint: on one device, x."""
        return x


_STATE = threading.local()


def current_partitioner() -> Optional[Partitioner]:
    return getattr(_STATE, "partitioner", None)


@contextlib.contextmanager
def set_partitioner(p: Optional[Partitioner]):
    prev = current_partitioner()
    _STATE.partitioner = p
    try:
        yield p
    finally:
        _STATE.partitioner = prev


def logical_constraint(x: torch.Tensor,
                       logical_axes: LogicalAxes) -> torch.Tensor:
    """The reference's module-level activation constraint: on one device
    the identity."""
    return x
