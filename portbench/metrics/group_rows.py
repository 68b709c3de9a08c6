"""Mean real rows (pad rows not counted) of the executed groups."""


def compute(record):
    gs = record["groups"]
    return sum(g["rows"] for g in gs) / len(gs) if gs else None
