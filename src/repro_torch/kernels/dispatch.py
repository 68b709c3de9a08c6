"""Kernel-path telemetry: which implementation ran, and how often the
hand-written kernels were launched.

Every kernel wrapper records its path here on each call: ``"torch"``
when it ran the plain PyTorch version on a CPU (or ``meta``) tensor
(:func:`plain`), ``"cuda"`` when it launched its kernel on a CUDA tensor
(:func:`count_launch`, which ``_build.launch`` calls after each launch).
There is no fallback path: on a CUDA tensor a wrapper launches its
kernel or raises.
``status()`` lets benchmarks and tests assert on what actually executed,
and the launch counts let a run show that its main path went through
the kernels.  A site with more than one kernel (flash_attention:
"wgmma" and "fp32") also records which variant ran, and counts launches
per variant.

A site may also keep an int64 counter on the device (:func:`device_counter`:
the MoE layer's routed rows per (layer, expert)), which its kernels add to
without waiting for the host and which a run reads only when it is over.
:func:`reset_launches` sets those to 0 too, and the host counters of
program events that are not launches (:func:`count_event`: the serving
executor's graph captures and kept-graph hits).

A launch made while its thread captures a CUDA graph runs nothing: it is
counted into the thread's :class:`Tally` (:func:`capturing`), and the
graph's owner adds the tally to the counts once per replay, so the
counts stay the launches that ran, graphed or not.
"""

from __future__ import annotations

import contextlib
import threading

import torch

PATHS = ("cuda", "torch")
#: devices whose tensors take the plain versions: the CPU, and ``meta``
#: (shapes only), where the dry run counts the plain versions' ops
PLAIN_DEVICES = ("cpu", "meta")

_lock = threading.Lock()
_STATUS: dict[str, dict] = {}
_LAUNCHES: dict[str, int] = {}
_VARIANTS: dict[str, dict[str, int]] = {}
_COUNTERS: dict[str, torch.Tensor] = {}
_EVENTS: dict[str, int] = {}
_local = threading.local()


class Tally:
    """The launches a thread counted while it captured one CUDA graph:
    ``{(site, variant): n}``."""

    def __init__(self) -> None:
        self.counts: dict[tuple, int] = {}

    def replayed(self) -> None:
        """Add the captured launches to the counts: one replay ran."""
        with _lock:
            for (site, variant), n in self.counts.items():
                _add(site, variant, n)


@contextlib.contextmanager
def capturing():
    """While inside, this thread's launches are counted into the yielded
    :class:`Tally` instead of the counts (the launches are being
    captured, not run); paths are recorded as always."""
    tally = Tally()
    _local.tally = tally
    try:
        yield tally
    finally:
        _local.tally = None


def record(site: str, path: str, variant: str | None = None) -> None:
    """Record that ``site`` (e.g. "mandelbrot") ran ``path``, and which
    ``variant`` of its kernel where it has several."""
    if path not in PATHS:
        raise ValueError(f"unknown kernel path {path!r}; one of {PATHS}")
    with _lock:
        _record(site, path, variant)


def _record(site: str, path: str, variant: str | None) -> None:
    """Set ``site``'s path record; holds _lock."""
    _STATUS[site] = ({"path": path} if variant is None
                     else {"path": path, "variant": variant})


def plain(device: torch.device, *sites: str) -> bool:
    """Whether a wrapper runs its plain version on ``device``'s tensors:
    True on :data:`PLAIN_DEVICES`, recording the "torch" path of each of
    ``sites``; False on a CUDA device, where it launches its kernels;
    any other device raises."""
    if device.type in PLAIN_DEVICES:
        with _lock:
            for site in sites:
                _record(site, "torch", None)
        return True
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return False


def status(site: str | None = None) -> dict:
    """Latest path per site: {site: {"path": ...}}, or one site's record
    (empty dict if it never ran)."""
    with _lock:
        snap = {s: dict(st) for s, st in _STATUS.items()}
    return snap.get(site, {}) if site is not None else snap


def count_launch(site: str, variant: str | None = None) -> None:
    """Add one to ``site``'s launch count (called right after a launch),
    and to its ``variant``'s, and record its "cuda" path with that
    variant; inside :func:`capturing` the launch goes to the thread's
    tally instead of the counts."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        key = (site, variant)
        tally.counts[key] = tally.counts.get(key, 0) + 1
    with _lock:
        if tally is None:
            _add(site, variant, 1)
        _record(site, "cuda", variant)


def _add(site: str, variant: str | None, n: int) -> None:
    """Add ``n`` launches of ``site`` (and ``variant``); holds _lock."""
    _LAUNCHES[site] = _LAUNCHES.get(site, 0) + n
    if variant is not None:
        per = _VARIANTS.setdefault(site, {})
        per[variant] = per.get(variant, 0) + n


def launches(site: str | None = None):
    """Launch count of one site, or {site: count} for all."""
    with _lock:
        return (_LAUNCHES.get(site, 0) if site is not None
                else dict(_LAUNCHES))


def variant_launches(site: str) -> dict[str, int]:
    """{variant: launch count} of one site (empty if none was counted)."""
    with _lock:
        return dict(_VARIANTS.get(site, {}))


def count_event(name: str) -> None:
    """Add one to the host counter ``name`` of a program event."""
    with _lock:
        _EVENTS[name] = _EVENTS.get(name, 0) + 1


def events(name: str | None = None):
    """Count of one program event (0 if never counted), or {name: count}
    for all."""
    with _lock:
        return _EVENTS.get(name, 0) if name is not None else dict(_EVENTS)


def device_counter(name: str, shape: tuple, device) -> torch.Tensor:
    """The int64 counter ``name`` of ``shape`` on ``device``, made with
    zeros the first time it is asked for there in that shape (a new shape
    or device replaces it)."""
    device = torch.device(device)
    t = _COUNTERS.get(name)       # the common case reads without the lock
    if t is not None and t.device == device and tuple(t.shape) == tuple(shape):
        return t
    with _lock:
        t = _COUNTERS.get(name)
        if t is None or t.device != device or tuple(t.shape) != tuple(shape):
            with torch.inference_mode(False):   # a normal tensor: reset
                t = torch.zeros(shape, dtype=torch.int64, device=device)
            _COUNTERS[name] = t
        return t


def device_counters() -> dict[str, torch.Tensor]:
    """{name: counter tensor} as they stand (read them after the work:
    reading a CUDA tensor waits for the device)."""
    with _lock:
        return dict(_COUNTERS)


def reset() -> None:
    """Forget every path record and set every count to 0, as in a process
    that never ran a kernel: what a forked child starts from, since counts
    are per process.  Takes a new lock: one that another thread of the
    parent held at the fork is never released in the child."""
    global _lock
    _lock = threading.Lock()
    _STATUS.clear()
    _LAUNCHES.clear()
    _VARIANTS.clear()
    _EVENTS.clear()
    _COUNTERS.clear()


def reset_launches() -> None:
    """Set every launch count, event count and device counter to 0."""
    with _lock:
        _LAUNCHES.clear()
        _VARIANTS.clear()
        _EVENTS.clear()
        for t in _COUNTERS.values():
            t.zero_()
