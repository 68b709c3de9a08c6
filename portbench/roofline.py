"""A kernel's share of its roofline over the profiled loop: the sum,
over the groups the loop executed, of the least time the kernel's work
needs (``counts/<kernel>.py``, real rows only) over the kernel's device
seconds in the trace, in %."""

from __future__ import annotations

from portbench.harness import load_module


def share(record: dict, kernel: str):
    tr = record["trace"]
    if not tr:
        return None
    dev_s = tr["kernel_s"].get(kernel)
    if not dev_s:
        return None
    count = load_module("counts", kernel).group_bound_s
    bound = sum(count(record["model"], g) for g in tr["groups"])
    return 100.0 * bound / dev_s if bound else None
