"""Share, in %, of the window's prefill work that replayed a CUDA graph
its lane kept: the prefill segments that did, from the program's host
counters ``prefill_graph_hit`` and ``prefill_graph_capture``
(``kernels.dispatch.events``, zeroed with the launch counts before the
window, read after it), over all its segments (a segment either replays
a kept graph or runs eagerly and then captures one).  A program that
prefilled no segment replayed nothing: 0 where the window's groups
prefilled whole.  None where no group ran, or the program keeps no
event counters."""

from repro_torch.kernels import dispatch

HITS, CAPTURES = "prefill_graph_hit", "prefill_graph_capture"


def compute(record):
    read = getattr(dispatch, "events", None)
    if read is None:
        return None
    hits, captures = read(HITS), read(CAPTURES)
    if hits + captures:
        return 100.0 * hits / (hits + captures)
    return 0.0 if record.get("groups") else None
