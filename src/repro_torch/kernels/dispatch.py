"""Kernel-path telemetry: which implementation ran, and how often the
hand-written kernels were launched.

Every kernel wrapper records its path here on each call: ``"cuda"`` when
it launched its kernel on a CUDA tensor, ``"torch"`` when it ran the
plain PyTorch version on a CPU tensor.  There is no fallback path: on a
CUDA tensor a wrapper launches its kernel or raises.  ``status()`` lets
benchmarks and tests assert on what actually executed, and the launch
counts let a run show that its main path went through the kernels.
"""

from __future__ import annotations

import threading

PATHS = ("cuda", "torch")

_lock = threading.Lock()
_STATUS: dict[str, dict] = {}
_LAUNCHES: dict[str, int] = {}


def record(site: str, path: str) -> None:
    """Record that ``site`` (e.g. "mandelbrot") ran ``path``."""
    if path not in PATHS:
        raise ValueError(f"unknown kernel path {path!r}; one of {PATHS}")
    with _lock:
        _STATUS[site] = {"path": path}


def status(site: str | None = None) -> dict:
    """Latest path per site: {site: {"path": ...}}, or one site's record
    (empty dict if it never ran)."""
    with _lock:
        snap = {s: dict(st) for s, st in _STATUS.items()}
    return snap.get(site, {}) if site is not None else snap


def count_launch(site: str) -> None:
    """Add one to ``site``'s launch count (called right after a launch)."""
    with _lock:
        _LAUNCHES[site] = _LAUNCHES.get(site, 0) + 1


def launches(site: str | None = None):
    """Launch count of one site, or {site: count} for all."""
    with _lock:
        return (_LAUNCHES.get(site, 0) if site is not None
                else dict(_LAUNCHES))


def reset_launches() -> None:
    """Set every launch count to 0."""
    with _lock:
        _LAUNCHES.clear()
