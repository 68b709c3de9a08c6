"""Helpers shared by the reference families: matrix products in float32
(or through float8 for the precision control), normalisation, blocks of
sequences sized to a memory budget."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

FP8_MAX = 448.0             # largest finite float8_e4m3fn


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one scale for the tensor
    (its largest magnitude at 448), back in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x @ w in float32; with ``precision="fp8"`` both operands are
    rounded to float8 e4m3 first (the control one precision below the
    served bfloat16)."""
    x, w = x.float(), w.float()
    if precision == "fp8":
        x, w = fp8(x), fp8(w)
    elif precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w


def layer_norm(x: torch.Tensor, scale=None, bias=None,
               eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) over the last axis, then the affine
    where given; float32."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions while inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def blocks(seqs: list, budget: float, cost) -> list[list[int]]:
    """Indices of ``seqs`` in blocks of similar length (longest first),
    each block's ``cost(rows, T)`` within ``budget`` (a block holds at
    least one sequence)."""
    order = sorted(range(len(seqs)), key=lambda i: -len(seqs[i]))
    out: list[list[int]] = []
    for i in order:
        if out and cost(len(out[-1]) + 1, len(seqs[out[-1][0]])) <= budget:
            out[-1].append(i)
        else:
            out.append([i])
    return out


def padded(seqs: list, idx: list[int], device) -> torch.Tensor:
    """(rows, T) int64 tokens of ``seqs[idx]``, right-padded with 0 (the
    models are causal: a pad never reaches an earlier position)."""
    T = max(len(seqs[i]) for i in idx)
    buf = np.zeros((len(idx), T), dtype=np.int64)
    for r, i in enumerate(idx):
        buf[r, :len(seqs[i])] = seqs[i]
    return torch.from_numpy(buf).to(device)
