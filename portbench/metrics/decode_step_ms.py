"""Milliseconds a decode step, over every executed group that decodes:
(group wall - prefill wall) / (new tokens - 1), summed over the groups
before the ratio.  Host clocks around the program's generator and
prefill."""


def compute(record):
    gs = [g for g in record["groups"] if g["n"] > 1]
    steps = sum(g["n"] - 1 for g in gs)
    if not steps:
        return None
    return 1e3 * sum(g["wall_s"] - g["prefill_s"] for g in gs) / steps
