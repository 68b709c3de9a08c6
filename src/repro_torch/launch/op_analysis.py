"""Operation counts of a step run on ``meta`` tensors: FLOPs, unfused
bytes and peak live bytes, with loops over time counted by trip count.

The port's counterpart of ``repro.launch.hlo_analysis``, which parses a
compiled HLO module.  PyTorch compiles nothing here, so the step runs
eagerly on ``meta`` tensors (shapes and dtypes, no memory, no kernel:
every kernel wrapper takes its plain version there) under two counters:

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s formulas (the
    matrix products, convolutions and attention calls — elementwise ops
    count nothing, as the reference counts only ``dot``s);
  * unfused bytes: a ``TorchDispatchMode`` that adds each op's input
    and output bytes.  Every op is its own kernel in eager PyTorch, so
    this is the traffic of running the ops one by one; views and
    allocations move nothing and are skipped.  It is an upper bound on
    what a fused program moves, beside which the dry run records the
    minimum: the parameters, optimizer state, cache and batch, each read
    or written once;
  * peak live bytes: the same mode adds each new tensor's bytes when an
    op returns it and takes them off when the tensor is freed; the
    highest sum is what the step holds at once beyond its inputs (its
    activations, gradients and temporaries).

Loops over time are counted as the reference counts while-loop bodies
(``hlo_analysis.py``: one trip times the trip count): inside
:class:`Counter` a loop over ``repro_torch.trips.trips(n)`` runs one
trip with autograd off, and both counters multiply it by n.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import trips

_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_unsafe_view", "set_", "resize_"}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Flops(FlopCounterMode):
    """FlopCounterMode with each op's count times the trip multiplier."""

    def _count_flops(self, func_packet, out, args, kwargs):
        if func_packet in self.flop_registry:
            flops = self.flop_registry[func_packet](*args, **kwargs,
                                                    out_val=out)
            flops = int(flops * trips.multiplier())
            for par in set(self.mod_tracker.parents):
                self.flop_counts[par][func_packet] += flops
        return out


class _Bytes(TorchDispatchMode):
    """Unfused bytes (inputs + outputs of every op that moves data,
    times the trip multiplier) and the peak of live new-tensor bytes."""

    def __init__(self):
        super().__init__()
        self.unfused = 0.0
        self.live = 0
        self.peak = 0

    def _freed(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.is_view or name in _NO_TRAFFIC:
            return out
        outs = _tensors(out)
        self.unfused += trips.multiplier() * (
            sum(_nbytes(t) for t in _tensors(args) + _tensors(kwargs))
            + sum(_nbytes(t) for t in outs))
        returns = func._schema.returns
        for i, t in enumerate(outs):
            fresh = i >= len(returns) or returns[i].alias_info is None
            if fresh:
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._freed, n)
        self.peak = max(self.peak, self.live)
        return out


class Counter:
    """``with Counter() as c: step(...)`` -> ``c.flops``,
    ``c.unfused_bytes``, ``c.peak_bytes`` (see the module docstring)."""

    def __enter__(self) -> "Counter":
        self._scope = trips.counted()
        self._scope.__enter__()
        self._flops = _Flops(display=False)
        self._flops.__enter__()
        self._bytes = _Bytes()
        self._bytes.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        self._scope.__exit__(*exc)
        self.flops = float(self._flops.get_total_flops())
        self.unfused_bytes = float(self._bytes.unfused)
        self.peak_bytes = int(self._bytes.peak)


# --------------------------------------------------------------- roofline
def roofline_terms(flops: float, bytes_hbm: float,
                   coll_bytes_total: float = 0.0, *, chips: int = 1,
                   peak_flops: float, hbm_bw: float,
                   ici_bw: float | None = None) -> dict:
    """The roofline terms in seconds (global work / global capacity), as
    the reference's; one card has no interconnect, so without
    ``ici_bw`` there is no collective term."""
    terms = {"t_compute": flops / (chips * peak_flops),
             "t_memory": bytes_hbm / (chips * hbm_bw)}
    if ici_bw is not None:
        terms["t_collective"] = coll_bytes_total / (chips * ici_bw)
    return terms


def dominant_term(terms: dict) -> str:
    return max(terms, key=lambda k: terms[k])
