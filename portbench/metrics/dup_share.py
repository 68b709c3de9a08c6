"""Duplicates the robust queue issued (``ServeStats.n_duplicates``),
summed over the window's loops, per 100 requests committed."""


def compute(record):
    done = sum(lp["n_committed"] for lp in record["loops"])
    if not done:
        return None
    return 100.0 * sum(lp["n_duplicates"] for lp in record["loops"]) / done
