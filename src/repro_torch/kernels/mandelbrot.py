"""Mandelbrot escape-time counts: the hand-written CUDA kernel
(``csrc/mandelbrot.cu``) and its plain PyTorch version.

Counterpart of ``repro.kernels.mandelbrot.mandelbrot`` (a Pallas TPU
kernel).  The count of a pixel is the number of iterations before
|z|^2 exceeded 4 (``max_iters`` if it never did).

Rounding follows the JAX reference as XLA runs it on the CPU: every
operation rounds on its own except the imaginary update, which is one
fused multiply-add, ``fma(2*zr, zi, ci)``.  Turning all contraction off
instead changes a few hundred pixels of the paper's 512 x 512 image.

The wrapper takes 2-D views with a unit column stride whose two inputs
share a row stride, such as a tile sliced out of the app's grid, so that
a task launches the kernel on the grid itself and copies nothing.  The
kernel runs ``GROUP`` iterations between two escape tests and replays a
group that escaped one iteration at a time; :func:`mandelbrot_replay_mirror`
is that loop in plain PyTorch, which the tests hold to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, dispatch

SITE = "mandelbrot"
#: iterations between two escape tests (``kGroup`` in csrc/mandelbrot.cu)
GROUP = 8
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


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
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} must have a unit column stride, got "
                             f"strides {t.stride()}")
    if c_real.shape != c_imag.shape:
        raise ValueError(f"shape mismatch {c_real.shape} vs {c_imag.shape}")
    if c_real.shape[0] > 1 and c_real.stride(0) != c_imag.stride(0):
        raise ValueError(f"c_real and c_imag must share a row stride, got "
                         f"{c_real.stride(0)} and {c_imag.stride(0)}")
    if c_real.device != c_imag.device:
        raise ValueError(f"device mismatch {c_real.device} vs "
                         f"{c_imag.device}")
    if max_iters < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    if c_real.numel() >= 2 ** 31:
        raise ValueError("grid too large for 32-bit extents")


def mandelbrot_replay_mirror(c_real: torch.Tensor, c_imag: torch.Tensor,
                             max_iters: int,
                             group: int = GROUP) -> torch.Tensor:
    """The kernel's loop in plain PyTorch: ``group`` iterations at a time,
    each keeping the largest |z|^2 it saw; a pixel whose group saw one
    above 4 goes back to the z the group started from and replays it one
    iteration at a time with the exact test, as do the last
    ``max_iters % group`` iterations.  The same rounded operations in the
    same order as :func:`mandelbrot_plain`, so the same counts."""
    zr = torch.zeros_like(c_real)
    zi = torch.zeros_like(c_imag)
    ci64 = c_imag.double()

    def step(zr, zi):
        zr2, zi2 = zr * zr, zi * zi
        nzi = ((2.0 * zr).double() * zi.double() + ci64).float()
        return zr2 + zi2, zr2 - zi2 + c_real, nzi

    count = torch.zeros(c_real.shape, dtype=torch.int32,
                        device=c_real.device)
    grouped = torch.ones(c_real.shape, dtype=torch.bool,
                         device=c_real.device)
    for _ in range(max_iters // group):
        gr, gi = zr, zi
        most = torch.zeros_like(zr)
        for _ in range(group):
            r2, gr, gi = step(gr, gi)
            most = torch.fmax(most, r2)
        go = grouped & ~(most > 4.0)
        zr = torch.where(go, gr, zr)
        zi = torch.where(go, gi, zi)
        count += go.to(torch.int32) * group
        grouped &= go
    running = torch.ones_like(grouped)
    for _ in range(max_iters):               # at most group - 1 steps run
        r2, nzr, nzi = step(zr, zi)
        running &= (count < max_iters) & ~(r2 > 4.0)
        zr = torch.where(running, nzr, zr)
        zi = torch.where(running, nzi, zi)
        count += running.to(torch.int32)
        if not bool(running.any()):
            break
    return count


def mandelbrot(c_real: torch.Tensor, c_imag: torch.Tensor, *,
               max_iters: int = 256) -> torch.Tensor:
    """Escape counts (M, N) int32 for an (M, N) float32 grid of c values,
    each input a 2-D view with a unit column stride, the two sharing a
    row stride; the output is contiguous.

    CPU and meta tensors take the plain version; CUDA tensors launch the
    kernel on the current stream or raise."""
    _check(c_real, c_imag, max_iters)
    dev = c_real.device
    if dev.type in dispatch.PLAIN_DEVICES:
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
    ld = c_real.stride(0) if M > 1 else N
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(c_real.data_ptr(), c_imag.data_ptr(), ld,
                        out.data_ptr(), M, N, int(max_iters), stream),
                     "mandelbrot")
    dispatch.count_launch(SITE)
    dispatch.record(SITE, "cuda")
    return out
