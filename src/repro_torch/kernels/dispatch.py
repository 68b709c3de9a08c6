"""Kernel-path telemetry: which implementation ran, and how often the
hand-written kernels were launched.

Every kernel wrapper records its path here on each call: ``"cuda"`` when
it launched its kernel on a CUDA tensor, ``"torch"`` when it ran the
plain PyTorch version on a CPU (or ``meta``) tensor.  There is no
fallback path: on a CUDA tensor a wrapper launches its kernel or raises.
``status()`` lets benchmarks and tests assert on what actually executed,
and the launch counts let a run show that its main path went through
the kernels.  A site with more than one kernel (flash_attention:
"wgmma" and "fp32") also records which variant ran, and counts launches
per variant.
"""

from __future__ import annotations

import threading

PATHS = ("cuda", "torch")
#: devices whose tensors take the plain versions: the CPU, and ``meta``
#: (shapes only), where the dry run counts the plain versions' ops
PLAIN_DEVICES = ("cpu", "meta")

_lock = threading.Lock()
_STATUS: dict[str, dict] = {}
_LAUNCHES: dict[str, int] = {}
_VARIANTS: dict[str, dict[str, int]] = {}


def record(site: str, path: str, variant: str | None = None) -> None:
    """Record that ``site`` (e.g. "mandelbrot") ran ``path``, and which
    ``variant`` of its kernel where it has several."""
    if path not in PATHS:
        raise ValueError(f"unknown kernel path {path!r}; one of {PATHS}")
    with _lock:
        _STATUS[site] = ({"path": path} if variant is None
                         else {"path": path, "variant": variant})


def status(site: str | None = None) -> dict:
    """Latest path per site: {site: {"path": ...}}, or one site's record
    (empty dict if it never ran)."""
    with _lock:
        snap = {s: dict(st) for s, st in _STATUS.items()}
    return snap.get(site, {}) if site is not None else snap


def count_launch(site: str, variant: str | None = None) -> None:
    """Add one to ``site``'s launch count (called right after a launch),
    and to its ``variant``'s."""
    with _lock:
        _LAUNCHES[site] = _LAUNCHES.get(site, 0) + 1
        if variant is not None:
            per = _VARIANTS.setdefault(site, {})
            per[variant] = per.get(variant, 0) + 1


def launches(site: str | None = None):
    """Launch count of one site, or {site: count} for all."""
    with _lock:
        return (_LAUNCHES.get(site, 0) if site is not None
                else dict(_LAUNCHES))


def variant_launches(site: str) -> dict[str, int]:
    """{variant: launch count} of one site (empty if none was counted)."""
    with _lock:
        return dict(_VARIANTS.get(site, {}))


def reset_launches() -> None:
    """Set every launch count to 0."""
    with _lock:
        _LAUNCHES.clear()
        _VARIANTS.clear()
