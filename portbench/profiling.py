"""Reading a ``torch.profiler`` trace of one loop: device seconds of
each kernel site, the union of device intervals (busy seconds), the
device operations that took most time, and the device's idle gaps
summed by what the host was doing at each gap's middle.

The profiler records CUDA activity only: it does not see the host ops of
the engine's worker threads.  What the host was doing comes from the
harness's own spans on every thread (``harness.Runner`` in a traced
run), on the same clock (the profiler's timestamps are Unix
nanoseconds, as ``time.time_ns``).  Reads the raw kineto events, which
stays quick on the hundreds of thousands of events of a loop
(``key_averages`` would take minutes)."""

from __future__ import annotations

import numpy as np

TOP = 10
NAME_CHARS = 160
#: harness span kinds, innermost first, and how a gap under each reads
LABELS = (("decode_step", "host in a decode step (model.decode_step)"),
          ("prefill", "host in a prefill (model.prefill)"),
          ("group", "host in the generator, outside prefill and steps"),
          ("chunk", "host in the executor's chunk, outside its groups"))
OUTSIDE = "host in the engine, no chunk running"


def _events(prof) -> list:
    """(start_ns, end_ns, name) of every device event of a profile."""
    from torch.autograd import DeviceType
    return [(e.start_ns(), e.end_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def _covered(t: np.ndarray, spans: list, kind: str) -> np.ndarray:
    """Whether each time in ``t`` lies inside a span of ``kind``."""
    iv = [(a, b) for a, b, k in spans if k == kind]
    if not iv:
        return np.zeros(len(t), dtype=bool)
    starts = np.sort(np.array([a for a, _ in iv], dtype=np.int64))
    ends = np.sort(np.array([b for _, b in iv], dtype=np.int64))
    return (np.searchsorted(starts, t, "right")
            - np.searchsorted(ends, t, "left")) > 0


def summarize(dev: list, spans: list, sites) -> dict:
    """Kernel seconds by site (names containing the site), busy seconds
    (union of device intervals), top device ops, and idle gaps summed
    by the innermost harness span open at their middle on any thread."""
    if not dev:
        return dict(kernel_s={}, busy_s=0.0, device_ops=[], idle_gaps=[],
                    n_device_events=0)
    dev = sorted(dev)
    start = np.array([d[0] for d in dev], dtype=np.int64)
    end = np.array([d[1] for d in dev], dtype=np.int64)
    names = [d[2] for d in dev]
    dur = (end - start) / 1e9
    kernel_s = {s: float(sum(t for n, t in zip(names, dur) if s in n))
                for s in sites}
    by_name: dict = {}
    for n, t in zip(names, dur):
        by_name[n] = by_name.get(n, 0.0) + float(t)
    # union of intervals: a gap opens where an event starts after the
    # latest end so far
    reach = np.maximum.accumulate(end)
    gap = start[1:] - reach[:-1]
    open_ = gap > 0
    busy = float((end.max() - start.min() - gap[open_].sum()) / 1e9)
    mid = (reach[:-1][open_] + start[1:][open_]) // 2
    secs = gap[open_] / 1e9
    left = np.ones(len(mid), dtype=bool)
    gaps: dict = {}
    for kind, label in LABELS:
        hit = left & _covered(mid, spans, kind)
        if hit.any():
            gaps[label] = float(secs[hit].sum())
        left &= ~hit
    if left.any():
        gaps[OUTSIDE] = float(secs[left].sum())

    def top(d):
        return [[k[:NAME_CHARS], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return dict(kernel_s=kernel_s, busy_s=busy, device_ops=top(by_name),
                idle_gaps=top(gaps), n_device_events=len(dev))


def read(prof, sites, spans: list) -> dict:
    return summarize(_events(prof), spans, sites)
