"""PSIA — parallel spin-image application (paper Table 1: N=20,000, LOW
task-time variance), on the card.

A task = one oriented point's spin image over the cloud (Eleliemy et al.
2016/2017).  Every task bins the same number of cloud points, so task
times are near-uniform — the paper's low-variance counterpart to
Mandelbrot.

The data is drawn with ``numpy.random.default_rng(seed)`` in float32:
``repro.apps.psia`` draws with ``jax.random``, whose bits PyTorch cannot
reproduce.  :func:`from_reference` carries the JAX package's arrays over
instead, for runs that must see the reference's data.  The cloud and the
oriented points live on the device, cached per (n, seed, device).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels.ops import spin_image as spin_image_kernel

PAPER_N = 20_000           # oriented points (tasks)
CLOUD = 16_384             # cloud points binned per task
N_ALPHA = N_BETA = 64
ALPHA_MAX = BETA_MAX = 3.0


class PsiaData(NamedTuple):
    """Device-resident app data: the cloud and the oriented points."""
    points: torch.Tensor       # (Np, 3) float32
    centers: torch.Tensor      # (Bo, 3) float32
    normals: torch.Tensor      # (Bo, 3) float32


@functools.lru_cache(maxsize=4)
def _cloud(n: int, seed: int, device: str) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3), dtype=np.float32)
    return torch.from_numpy(pts).to(device)


def cloud(n: int = CLOUD, seed: int = 0, *, device=None) -> torch.Tensor:
    """(n, 3) float32 cloud, standard normal (read-only, cached)."""
    return _cloud(int(n), int(seed), str(resolve(device)))


@functools.lru_cache(maxsize=4)
def _oriented(n: int, seed: int, device: str
              ) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(seed)
    ctr = rng.standard_normal((n, 3), dtype=np.float32) * np.float32(0.5)
    nrm = rng.standard_normal((n, 3), dtype=np.float32)
    nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    return (torch.from_numpy(ctr).to(device),
            torch.from_numpy(nrm.astype(np.float32)).to(device))


def oriented_points(n: int = PAPER_N, seed: int = 1, *, device=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(centers, unit normals), each (n, 3) float32 (read-only, cached)."""
    return _oriented(int(n), int(seed), str(resolve(device)))


def from_reference(points, centers, normals, *, device=None) -> PsiaData:
    """The JAX package's cloud and oriented points (numpy arrays, e.g.
    ``np.asarray(repro.apps.psia.cloud())``) as device-resident data for
    :func:`compute_tasks`."""
    dev = resolve(device)
    return PsiaData(*(torch.from_numpy(np.array(a, np.float32)).to(dev)
                      for a in (points, centers, normals)))


def dataset(*, n: int = PAPER_N, cloud_n: int = CLOUD, device=None
         ) -> PsiaData:
    """The port's own app data at the given sizes."""
    return PsiaData(cloud(cloud_n, device=device),
                    *oriented_points(n, device=device))


def task_times(n_tasks: int = PAPER_N, *, cloud_n: int = CLOUD,
               time_per_point: float = 1.7e-5, jitter: float = 0.05,
               seed: int = 0) -> np.ndarray:
    """Near-uniform per-task durations (low variance, as in the paper).

    time_per_point is calibrated so a task ~ 0.28 s and the P=256 parallel
    time ~ 22 s — the paper's Fig. 3 PSIA scale, which matters because the
    perturbation experiments inject ABSOLUTE 10 s message delays."""
    rng = np.random.default_rng(seed)
    base = cloud_n * time_per_point
    return base * (1.0 + jitter * rng.standard_normal(n_tasks)).clip(0.5)


def compute_tasks(task_ids, *, n: int = PAPER_N, cloud_n: int = CLOUD,
                  n_alpha: int = N_ALPHA, n_beta: int = N_BETA,
                  device=None, data: Optional[PsiaData] = None
                  ) -> np.ndarray:
    """Spin images (len(task_ids), n_beta, n_alpha) float32 for a chunk of
    oriented points (runtime tasks), returned on the host.  ``data``
    (e.g. from :func:`from_reference`) replaces the port's own data, and
    then its device is used."""
    if data is None:
        data = dataset(n=n, cloud_n=cloud_n, device=device)
    dev = data.points.device
    ids = torch.as_tensor(np.asarray(task_ids, dtype=np.int64), device=dev)
    return spin_image_kernel(
        data.points, data.centers[ids], data.normals[ids],
        n_alpha=n_alpha, n_beta=n_beta, alpha_max=ALPHA_MAX,
        beta_max=BETA_MAX).cpu().numpy()
