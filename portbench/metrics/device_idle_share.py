"""Share of the profiled loop's wall time in which no device operation
ran (1 - union of device intervals / loop wall), in %."""


def compute(record):
    tr = record["trace"]
    if not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["span_s"])
