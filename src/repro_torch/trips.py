"""Loops over time, counted one trip at a time by an op count.

The dry run (``repro_torch.launch.dryrun``) counts a step's operations
and bytes over a run on ``meta`` tensors (``launch.op_analysis``).  A
loop over time would walk every step there: hymba's selective scan at
32,768 tokens is 32,768 trips a layer, rwkv6's chunked WKV6 1,024.  So a
loop written

    for t in trips(n):
        ...

runs its n trips as ``range(n)`` would, except under an op count with
autograd off: then it runs trip 0 alone, and the count multiplies what
that trip dispatches by n — as the reference's HLO analysis counts a
while-loop body once, times its trip count.  Its trips must do the same
work (a shorter last chunk is counted as a whole one); per-trip results
gathered in a list go through :func:`full` before their ``cat`` or
``stack``.

With autograd on, every trip runs (the backward of a skipped trip
would go uncounted); the training step's microbatch loop runs with
autograd off around each microbatch's own value-and-grad.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


def _mult() -> list:
    stack = getattr(_state, "mult", None)
    if stack is None:
        stack = _state.mult = []
    return stack


def multiplier() -> float:
    """What the active op count multiplies each op by (1 outside any
    skipped loop)."""
    stack = _mult()
    return stack[-1] if stack else 1.0


@contextlib.contextmanager
def counted():
    """An op count's scope: inside it, :func:`trips` skips trips."""
    stack = _mult()
    stack.append(multiplier())
    try:
        yield
    finally:
        stack.pop()


def trips(n: int):
    """``range(n)``, or trip 0 alone with the multiplier times n under
    an op count with autograd off."""
    stack = _mult()
    if not stack or n <= 1 or torch.is_grad_enabled():
        yield from range(n)
        return
    stack.append(stack[-1] * n)
    try:
        yield 0
    finally:
        stack.pop()


def full(parts: list, n: int) -> list:
    """The n per-trip results of a loop over ``trips(n)``: ``parts``
    itself, or after a skipped loop its one result n times, so the
    ``cat`` or ``stack`` that follows has the shape and the bytes of n
    trips."""
    return parts if len(parts) == n else parts * n
