"""Mandelbrot escape-time counts: the hand-written CUDA kernel
(``csrc/mandelbrot.cu``) and its plain PyTorch version.

Counterpart of ``repro.kernels.mandelbrot.mandelbrot`` (a Pallas TPU
kernel).  The count of a pixel is the number of iterations before
|z|^2 exceeded 4 (``max_iters`` if it never did).

Rounding follows the JAX reference as XLA runs it on the CPU: every
operation rounds on its own except the imaginary update, which is one
fused multiply-add, ``fma(2*zr, zi, ci)``.  Turning all contraction off
instead changes a few hundred pixels of the paper's 512 x 512 image.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch

SITE = "mandelbrot"
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def mandelbrot_plain(c_real: torch.Tensor, c_imag: torch.Tensor,
                     max_iters: int) -> torch.Tensor:
    """Plain PyTorch escape counts (int32), the same arithmetic as the
    kernel.  Escaped lanes are frozen, as in the TPU kernel.

    ``nzi`` emulates the kernel's FMA: ``2*zr`` is exact, the product of
    two float32 values is exact in float64, and the float64 sum is then
    rounded to float32.  That differs from a true FMA only where the
    float64 sum rounds onto a float32 halfway point; none occurs over the
    paper's 512 x 512 image at 256 iterations."""
    zr = torch.zeros_like(c_real)
    zi = torch.zeros_like(c_imag)
    ci64 = c_imag.double()
    count = torch.zeros(c_real.shape, dtype=torch.int32,
                        device=c_real.device)
    for _ in range(max_iters):
        zr2, zi2 = zr * zr, zi * zi
        escaped = zr2 + zi2 > 4.0
        nzr = zr2 - zi2 + c_real
        nzi = ((2.0 * zr).double() * zi.double() + ci64).float()
        zr = torch.where(escaped, zr, nzr)
        zi = torch.where(escaped, zi, nzi)
        count += (~escaped).to(torch.int32)
    return count


def _check(c_real: torch.Tensor, c_imag: torch.Tensor,
           max_iters: int) -> None:
    for name, t in (("c_real", c_real), ("c_imag", c_imag)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D (M, N), got {t.shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if c_real.shape != c_imag.shape:
        raise ValueError(f"shape mismatch {c_real.shape} vs {c_imag.shape}")
    if c_real.device != c_imag.device:
        raise ValueError(f"device mismatch {c_real.device} vs "
                         f"{c_imag.device}")
    if max_iters < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    if c_real.numel() >= 2 ** 31:
        raise ValueError("grid too large for 32-bit extents")


def mandelbrot(c_real: torch.Tensor, c_imag: torch.Tensor, *,
               max_iters: int = 256) -> torch.Tensor:
    """Escape counts (M, N) int32 for an (M, N) float32 grid of c values.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream or raise."""
    _check(c_real, c_imag, max_iters)
    dev = c_real.device
    if dev.type == "cpu":
        dispatch.record(SITE, "torch")
        return mandelbrot_plain(c_real, c_imag, max_iters)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(c_real.shape, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        dispatch.record(SITE, "cuda")
        return out
    fn = _build.function("mandelbrot_launch", _ARGTYPES)
    M, N = c_real.shape
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(c_real.data_ptr(), c_imag.data_ptr(),
                        out.data_ptr(), M, N, int(max_iters), stream),
                     "mandelbrot")
    dispatch.count_launch(SITE)
    dispatch.record(SITE, "cuda")
    return out
