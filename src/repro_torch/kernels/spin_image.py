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

Two choices of the kernel have plain mirrors here, which the tests hold
to :func:`spin_image_plain`: the split of a center's cloud over the CTAs
of a cluster (:func:`pt_split`, :func:`pt_ranges`,
:func:`spin_image_split_mirror`), and the guarded fast binning, which
takes the correctly rounded chain only for a coordinate within ``EPS``
of a bin edge (:func:`spin_image_guard_mirror`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, dispatch

SITE = "spin_image"
#: the most shared memory one block may use on Hopper (227 KB)
MAX_SHARED_BYTES = 232_448
#: CTAs a launch should reach (two an SM of an H100's 132), the fewest
#: cloud points a CTA should bin, and the most CTAs a center's cloud is
#: split over (a portable cluster)
TARGET_CTAS = 2 * 132
MIN_POINTS = 1024
MAX_SPLIT = 8
#: the relative margin of the fast binning's guard (``kEps`` in
#: csrc/spin_image.cu)
EPS = 2.0 ** -19
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
             ctypes.c_void_p]


def pt_split(n_centers: int, n_points: int) -> int:
    """CTAs each center's cloud is split over: doubled from 1 while
    n_centers x split is under TARGET_CTAS and each CTA keeps at least
    MIN_POINTS points, up to MAX_SPLIT (one cluster).  A function of the
    shapes alone."""
    n = 1
    while (n_centers * n < TARGET_CTAS and 2 * n <= MAX_SPLIT
           and n_points // (2 * n) >= MIN_POINTS):
        n *= 2
    return n


def pt_ranges(n_points: int, split: int) -> list[tuple[int, int]]:
    """The cloud points [p0, p1) of each of a center's ``split`` CTAs, in
    rank order: ceil(n_points / split) rounded up to a multiple of 4 each
    (the kernel reads 4 points at a time), the last range ragged."""
    per = -(-n_points // split)
    per = -(-per // 4) * 4
    return [(min(n_points, r * per), min(n_points, (r + 1) * per))
            for r in range(split)]


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
    beta, a2 = _cylinder(points, centers, normals)
    af, bf = _exact_bins(beta, a2, n_alpha, n_beta, alpha_max, beta_max)
    return _histogram(af, bf, n_alpha, n_beta)


def _cylinder(points, centers, normals):
    """beta and alpha^2 (clamped at 0) of every (center, point) pair,
    (Bo, Np) each, every operation rounded on its own."""
    p = points[None, :, :]
    c = centers[:, None, :]
    n = normals[:, None, :]
    dx = p[..., 0] - c[..., 0]                              # (Bo, Np)
    dy = p[..., 1] - c[..., 1]
    dz = p[..., 2] - c[..., 2]
    beta = (dx * n[..., 0] + dy * n[..., 1]) + dz * n[..., 2]
    r2 = (dx * dx + dy * dy) + dz * dz
    return beta, torch.clamp_min(r2 - beta * beta, 0.0)


def _exact_bins(beta, a2, n_alpha, n_beta, alpha_max, beta_max):
    """The floored bin coordinates through the correctly rounded chain."""
    dev = beta.device
    am = torch.tensor(alpha_max, dtype=torch.float32, device=dev)
    bm2 = torch.tensor(2.0 * beta_max, dtype=torch.float32, device=dev)
    af = torch.floor(sqrt_rn(a2) / am * float(n_alpha))
    bf = torch.floor((beta + beta_max) / bm2 * float(n_beta))
    return af, bf


def _histogram(af, bf, n_alpha, n_beta):
    valid = (af >= 0) & (af < n_alpha) & (bf >= 0) & (bf < n_beta)
    idx = torch.where(valid, bf * n_alpha + af,
                      torch.zeros_like(af)).to(torch.int64)
    hist = torch.zeros((af.shape[0], n_beta * n_alpha),
                       dtype=torch.int32, device=af.device)
    hist.scatter_add_(1, idx, valid.to(torch.int32))
    return hist.to(torch.float32).reshape(-1, n_beta, n_alpha)


def bin_edge_cloud(*, n_alpha: int, n_beta: int, alpha_max: float,
                   beta_max: float
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Test inputs on the bins' edges: one oriented point at the origin
    with normal +z, and a cloud (float32, on the CPU) whose bin
    coordinates lie on every bin edge and range end, and one ulp to
    either side of each: alpha = |x| at x = k alpha_max / n_alpha, and
    beta = z at z = 2 k beta_max / n_beta - beta_max.  They lie exactly
    on the edges where those values are exact in float32, as at the
    paper's 3.0 and 64 bins."""
    f = np.float32

    def around(x):
        x = x.astype(f)
        return np.concatenate([np.nextafter(x, f(-np.inf)), x,
                               np.nextafter(x, f(np.inf))])

    xs = around(np.arange(n_alpha + 2, dtype=f) * f(alpha_max) / f(n_alpha))
    zs = around(np.arange(-1, n_beta + 2, dtype=f) * f(2 * beta_max)
                / f(n_beta) - f(beta_max))
    x, z = np.meshgrid(xs, zs)
    pts = np.stack([x.ravel(), np.zeros(x.size, f), z.ravel()], axis=1)
    return (torch.from_numpy(np.ascontiguousarray(pts)),
            torch.zeros((1, 3)), torch.tensor([[0.0, 0.0, 1.0]]))


def spin_image_split_mirror(points: torch.Tensor, centers: torch.Tensor,
                            normals: torch.Tensor, *, split: int,
                            **kw) -> torch.Tensor:
    """The kernel's split in plain PyTorch: each of ``split`` ranks bins
    its range of the cloud (:func:`pt_ranges`) into its own histogram,
    and the counts are summed in rank order.  Each partial count is an
    integer, so the sum is exact and equals :func:`spin_image_plain`."""
    out = None
    for p0, p1 in pt_ranges(points.shape[0], split):
        part = spin_image_plain(points[p0:p1], centers, normals, **kw)
        out = part if out is None else out + part
    return out


def spin_image_guard_mirror(points: torch.Tensor, centers: torch.Tensor,
                            normals: torch.Tensor, *, n_alpha: int,
                            n_beta: int, alpha_max: float, beta_max: float,
                            rsqrt=torch.rsqrt
                            ) -> tuple[torch.Tensor, int]:
    """The kernel's fast binning in plain PyTorch, with ``rsqrt`` in place
    of the card's (any approximation within 2 ulp): alpha formed as
    a2 * rsqrt(max(a2, FLT_MIN)), each division as a product with a
    reciprocal rounded once; each coordinate clamped to
    [-0.5, n + 0.5] (a NaN to -0.5) and kept where no integer lies within
    EPS of it, the correctly rounded chain elsewhere.  Returns the spin
    images and how many pairs took the correctly rounded chain."""
    beta, a2 = _cylinder(points, centers, normals)
    fa, fb = np.float32(n_alpha), np.float32(n_beta)
    am, bm = np.float32(alpha_max), np.float32(beta_max)
    ka = float(np.float32(float(fa) / float(am)))
    kb = float(np.float32(float(fb) / float(np.float32(2 * bm))))
    tiny = float(np.finfo(np.float32).tiny)

    def coarse(x, n):
        # the kernel's floors of x (1 -+ EPS) round once, as these float64
        # products (exact for a float32 x) do
        x = torch.where(torch.isnan(x), -0.5, x).clamp(-0.5, n + 0.5)
        lo = torch.floor(x.double() * (1.0 - EPS))
        return lo.float(), lo == torch.floor(x.double() * (1.0 + EPS))

    alpha = a2 * rsqrt(torch.clamp_min(a2, tiny))
    af, ok_a = coarse(alpha * ka, n_alpha)
    bf, ok_b = coarse((beta + beta_max) * kb, n_beta)
    keep = ok_a & ok_b
    xa, xb = _exact_bins(beta, a2, n_alpha, n_beta, alpha_max, beta_max)
    af = torch.where(keep, af, xa)
    bf = torch.where(keep, bf, xb)
    return (_histogram(af, bf, n_alpha, n_beta),
            int((~keep).sum()))


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

    CPU and meta tensors take the plain version; CUDA tensors launch the
    kernel on the current stream or raise."""
    _check(points, centers, normals, n_alpha, n_beta)
    dev = points.device
    if dispatch.plain(dev, SITE):
        return spin_image_plain(points, centers, normals, n_alpha=n_alpha,
                                n_beta=n_beta, alpha_max=alpha_max,
                                beta_max=beta_max)
    Bo = centers.shape[0]
    out = torch.empty((Bo, n_beta, n_alpha), dtype=torch.float32,
                      device=dev)
    if Bo == 0:
        dispatch.record(SITE, "cuda")
        return out
    split = pt_split(Bo, points.shape[0])
    _build.launch("spin_image_launch", _ARGTYPES, SITE, dev,
                  points.data_ptr(), points.shape[0], centers.data_ptr(),
                  normals.data_ptr(), out.data_ptr(), Bo, n_alpha, n_beta,
                  float(alpha_max), float(beta_max), split)
    return out
