"""Share, in %, of the graphed request groups that replayed a decode-step
CUDA graph their lane kept from an earlier group instead of capturing
one, from the program's host counters ``graph_hit`` and
``graph_capture`` (``kernels.dispatch.events``, zeroed with the launch
counts before the window, read after it).  None where the program keeps
no such counters or graphed no group."""

from repro_torch.kernels import dispatch

HITS, CAPTURES = "graph_hit", "graph_capture"


def compute(record):
    read = getattr(dispatch, "events", None)
    if read is None:
        return None
    hits, captures = read(HITS), read(CAPTURES)
    if not hits + captures:
        return None
    return 100.0 * hits / (hits + captures)
