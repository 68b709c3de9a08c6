"""Busy replica-seconds over replicas x span, from the engine's flight
recorder (``Trace.utilization``) of each loop, over the window's loops
(traced runs), in %."""


def compute(record):
    spans = [lp["worker_busy"] for lp in record["loops"]
             if lp.get("worker_busy")]
    total = sum(s for _, s in spans)
    if not total:
        return None
    return 100.0 * sum(b * s for b, s in spans) / total
