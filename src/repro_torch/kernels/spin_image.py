"""PSIA spin images: the hand-written CUDA kernel (``csrc/spin_image.cu``)
and its plain PyTorch version.

Counterpart of ``repro.kernels.spin_image.spin_image`` (a Pallas TPU
kernel).  For each oriented point (center c, normal n), every cloud
point x is binned in cylinder coordinates

    beta  = n . (x - c)
    alpha = sqrt(max(|x - c|^2 - beta^2, 0))

into an (n_beta, n_alpha) histogram; points outside it are dropped.

Both versions compute beta and |x - c|^2 as explicit component sums in
the order x, y, z, with every operation rounded on its own, so they agree
bin for bin.  The JAX package reduces in its own order, so a point that
lies on a bin edge can land in the neighbouring bin there: the parity
with the reference is a bound on moved points, not equality.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch

SITE = "spin_image"
#: the most shared memory one block may use on Hopper (227 KB)
MAX_SHARED_BYTES = 232_448
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (what ``__fsqrt_rn`` gives):
    taken in float64 and rounded once, which is exact for a square root.
    PyTorch's float32 ``sqrt`` on the CPU is not correctly rounded (one
    ulp off for some inputs), and its first call in a process may take
    another code path on one thread."""
    return torch.sqrt(x.double()).to(torch.float32)


def spin_image_plain(points: torch.Tensor, centers: torch.Tensor,
                     normals: torch.Tensor, *, n_alpha: int, n_beta: int,
                     alpha_max: float, beta_max: float) -> torch.Tensor:
    """Plain PyTorch spin images (Bo, n_beta, n_alpha) float32, the same
    arithmetic as the kernel, every operation correctly rounded:

    * divisors are 0-d tensors on the inputs' device, so that CUDA
      divides exactly instead of multiplying by a rounded reciprocal, as
      it does for a Python scalar divisor;
    * the square root is :func:`sqrt_rn`."""
    dev = points.device
    am = torch.tensor(alpha_max, dtype=torch.float32, device=dev)
    bm2 = torch.tensor(2.0 * beta_max, dtype=torch.float32, device=dev)
    p = points[None, :, :]
    c = centers[:, None, :]
    n = normals[:, None, :]
    dx = p[..., 0] - c[..., 0]                              # (Bo, Np)
    dy = p[..., 1] - c[..., 1]
    dz = p[..., 2] - c[..., 2]
    beta = (dx * n[..., 0] + dy * n[..., 1]) + dz * n[..., 2]
    r2 = (dx * dx + dy * dy) + dz * dz
    alpha = sqrt_rn(torch.clamp_min(r2 - beta * beta, 0.0))
    af = torch.floor(alpha / am * float(n_alpha))
    bf = torch.floor((beta + beta_max) / bm2 * float(n_beta))
    valid = (af >= 0) & (af < n_alpha) & (bf >= 0) & (bf < n_beta)
    idx = torch.where(valid, bf * n_alpha + af,
                      torch.zeros_like(af)).to(torch.int64)
    hist = torch.zeros((centers.shape[0], n_beta * n_alpha),
                       dtype=torch.int32, device=dev)
    hist.scatter_add_(1, idx, valid.to(torch.int32))
    return hist.to(torch.float32).reshape(-1, n_beta, n_alpha)


def _check(points: torch.Tensor, centers: torch.Tensor,
           normals: torch.Tensor, n_alpha: int, n_beta: int) -> None:
    for name, t in (("points", points), ("centers", centers),
                    ("normals", normals)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be (n, 3), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != points.device:
            raise ValueError(f"{name} is on {t.device}, points on "
                             f"{points.device}")
    if centers.shape != normals.shape:
        raise ValueError(f"centers {tuple(centers.shape)} and normals "
                         f"{tuple(normals.shape)} differ")
    if n_alpha <= 0 or n_beta <= 0:
        raise ValueError(f"need n_alpha, n_beta > 0, got {n_alpha}, "
                         f"{n_beta}")
    if 4 * n_alpha * n_beta > MAX_SHARED_BYTES:
        raise ValueError(f"{n_beta}x{n_alpha} int32 bins do not fit in "
                         f"{MAX_SHARED_BYTES} bytes of shared memory")
    if points.shape[0] >= 2 ** 31 // 3 or centers.shape[0] >= 2 ** 31:
        raise ValueError("too many points for 32-bit indexing")


def spin_image(points: torch.Tensor, centers: torch.Tensor,
               normals: torch.Tensor, *, n_alpha: int = 64,
               n_beta: int = 64, alpha_max: float = 1.0,
               beta_max: float = 1.0) -> torch.Tensor:
    """points: (Np, 3) f32; centers/normals: (Bo, 3) f32 ->
    (Bo, n_beta, n_alpha) f32 spin images.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream or raise."""
    _check(points, centers, normals, n_alpha, n_beta)
    dev = points.device
    if dev.type == "cpu":
        dispatch.record(SITE, "torch")
        return spin_image_plain(points, centers, normals, n_alpha=n_alpha,
                                n_beta=n_beta, alpha_max=alpha_max,
                                beta_max=beta_max)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    Bo = centers.shape[0]
    out = torch.empty((Bo, n_beta, n_alpha), dtype=torch.float32,
                      device=dev)
    if Bo == 0:
        dispatch.record(SITE, "cuda")
        return out
    fn = _build.function("spin_image_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(points.data_ptr(), points.shape[0],
                        centers.data_ptr(), normals.data_ptr(),
                        out.data_ptr(), Bo, n_alpha, n_beta,
                        float(alpha_max), float(beta_max), stream),
                     "spin_image")
    dispatch.count_launch(SITE)
    dispatch.record(SITE, "cuda")
    return out
