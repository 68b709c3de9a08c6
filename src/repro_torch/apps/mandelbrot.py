"""Mandelbrot application (paper Table 1: N=262,144, HIGH task-time
variance), on the card.

The paper schedules the 512x512 = 262,144 pixel iterations as independent
tasks.  Two faces here, as in ``repro.apps.mandelbrot``:

  * ``task_times()`` — per-task nominal durations for the discrete-event
    simulator, derived from the REAL escape counts of the assigned region
    (time proportional to iterations executed);
  * ``compute_tile()`` — the actual compute through the CUDA kernel, used
    by rDLB runs that re-execute real tiles after injected failures.

Every function that computes takes ``device=`` (``None`` means the card);
``n_tiles`` and ``assemble`` are host bookkeeping.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels.ops import mandelbrot as mandelbrot_kernel

REGION = (-2.0, 0.6, -1.3, 1.3)        # the classic view
PAPER_N = 262_144                      # 512 x 512
SIDE = 512
MAX_ITERS = 256


@functools.lru_cache(maxsize=8)
def _grid(side: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    x0, x1, y0, y1 = REGION
    xs = np.linspace(x0, x1, side)             # float64
    ys = np.linspace(y0, y1, side)
    cr, ci = np.meshgrid(xs, ys)
    return (torch.from_numpy(cr.astype(np.float32)).to(device),
            torch.from_numpy(ci.astype(np.float32)).to(device))


def grid(side: int = SIDE, *, device=None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (side, side) float32 grid of c values, resident on ``device``
    and cached per (side, device).  Treat it as read-only.

    It is computed in float64 on the host and rounded once to float32, so
    the CPU and the card get the same bits.  ``repro.apps.mandelbrot.grid``
    gets its bits from XLA's compiled ``linspace``, which rounds
    differently (and differently again per platform): the two grids
    differ by at most about 1e-7 per value, and the escape counts on them
    in a few pixels along the set's boundary.  To reproduce the JAX image
    exactly, pass its grid to :func:`escape_counts` as ``c``."""
    return _grid(int(side), str(resolve(device)))


def _counts(cr: torch.Tensor, ci: torch.Tensor,
            max_iters: int) -> np.ndarray:
    return mandelbrot_kernel(cr, ci, max_iters=max_iters).cpu().numpy()


@functools.lru_cache(maxsize=8)
def _escape_counts(side: int, max_iters: int, device: str) -> np.ndarray:
    cr, ci = _grid(side, device)
    out = _counts(cr, ci, max_iters)
    out.setflags(write=False)
    return out


def escape_counts(side: int = SIDE, max_iters: int = MAX_ITERS, *,
                  device=None,
                  c: Optional[tuple[np.ndarray, np.ndarray]] = None
                  ) -> np.ndarray:
    """Escape counts (side, side) int32 over :func:`grid` (cached, read
    only), or over an explicit ``c = (c_real, c_imag)`` pair of float32
    numpy arrays, such as the JAX package's grid (not cached)."""
    dev = resolve(device)
    if c is None:
        return _escape_counts(int(side), int(max_iters), str(dev))
    cr, ci = (torch.from_numpy(np.array(a, np.float32)).to(dev) for a in c)
    return _counts(cr, ci, int(max_iters))


def task_times(n_tasks: int = PAPER_N, *, side: int = SIDE,
               max_iters: int = MAX_ITERS,
               time_per_iter: float = 6e-4, device=None,
               c: Optional[tuple[np.ndarray, np.ndarray]] = None
               ) -> np.ndarray:
    """Per-task durations for the simulator (task = pixel, row-major).
    If n_tasks < side*side, tasks are contiguous pixel groups.

    time_per_iter calibrated to the paper's Fig. 3 Mandelbrot scale
    (P=256 parallel time tens of seconds, task times 0..~0.15 s with the
    high variance coming from the real escape-count distribution)."""
    iters = escape_counts(side, max_iters, device=device,
                          c=c).reshape(-1).astype(np.float64)
    per_pixel = iters * time_per_iter + 1e-7
    if n_tasks == per_pixel.size:
        return per_pixel
    group = per_pixel.size // n_tasks
    return per_pixel[:n_tasks * group].reshape(n_tasks, group).sum(axis=1)


def compute_tile(tile_id: int, *, side: int = SIDE, tile: int = 64,
                 max_iters: int = MAX_ITERS, device=None) -> np.ndarray:
    """Compute one (tile x tile) tile — a runtime task. Deterministic.
    Slices the cached device grid; returns the counts on the host."""
    per_row = side // tile
    ty, tx = divmod(tile_id, per_row)
    cr, ci = grid(side, device=device)
    sl = (slice(ty * tile, (ty + 1) * tile),
          slice(tx * tile, (tx + 1) * tile))
    return _counts(cr[sl].contiguous(), ci[sl].contiguous(), max_iters)


def n_tiles(side: int = SIDE, tile: int = 64) -> int:
    return (side // tile) ** 2


def assemble(tiles: dict, *, side: int = SIDE, tile: int = 64) -> np.ndarray:
    img = np.zeros((side, side), np.int32)
    per_row = side // tile
    for tid, data in tiles.items():
        ty, tx = divmod(tid, per_row)
        img[ty * tile:(ty + 1) * tile, tx * tile:(tx + 1) * tile] = data
    return img
