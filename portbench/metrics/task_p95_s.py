"""95th percentile, over the requests committed in the window, of
commit time minus the start of the request's loop (numpy's linear
interpolation)."""

import numpy as np


def compute(record):
    t = [c["since_loop_s"] for c in record["commits"]]
    return float(np.percentile(t, 95)) if t else None
