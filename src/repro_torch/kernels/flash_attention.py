"""Single-query (decode) attention over a KV cache: the hand-written CUDA
kernel (``csrc/flash_decode.cu``) and its plain PyTorch version.

Counterpart of ``repro.kernels.flash_attention.flash_decode`` (a Pallas
TPU kernel, body ``_decode_kernel``).  Two entry points share the one
kernel and its launch count (site ``flash_decode``):

  * :func:`flash_decode` takes the reference's folded layout, q (B, D)
    against k (B, L, D) and v (B, L, Dv);
  * :func:`flash_decode_gqa` takes the serving cache as it is stored,
    q (B, H, D) against k (B, L, KV, D) and v (B, L, KV, Dv), query head
    h reading KV head h // (H // KV): no repeat and no transpose of the
    cache (the reference folds both, ``attention.py:283-285``).

Both take a shared (L,) validity mask (bool or int, nonzero = the slot
takes part), accumulate in float32 and return q's dtype.  Masked slots
contribute nothing; a row without a valid slot returns zeros, as the TPU
kernel's re-zeroed probabilities give.  Any L is taken: the reference's
caller gates on ``L % min(128, L) == 0`` (a TPU block constraint), the
port does not.  ``flash_attention`` (the full-sequence kernel) is not
ported yet: ROADMAP.md queue B, item B6.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, dispatch

SITE = "flash_decode"
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
MAX_DIM = 256                                # largest D and Dv the kernel takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5
             + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 6
             + [ctypes.c_float, ctypes.c_void_p])


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid: torch.Tensor, *,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch single-query attention: q (B, D), k (B, L, D),
    v (B, L, Dv), valid (L,) -> (B, Dv) in q's dtype, float32 inside."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    ok = (valid != 0)[None, :]
    s = torch.einsum("bd,bld->bl", q.float(), k.float()) * scale
    s = torch.where(ok, s, NEG_INF)
    m = s.max(dim=-1, keepdim=True).values
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bl,bld->bd", p, v.float())
    return (out / torch.clamp(l, min=1e-30)).to(q.dtype)


def _fold(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, L, KV, D) -> (B * n_heads, L, D), each KV head repeated for its
    query heads (the reference's ``_repeat_kv`` + transpose)."""
    B, L, kv, D = k.shape
    k = torch.repeat_interleave(k, n_heads // kv, dim=2)
    return k.transpose(1, 2).reshape(B * n_heads, L, D)


def flash_decode_gqa_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, valid: torch.Tensor, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`flash_decode_gqa`: fold, then
    :func:`flash_decode_plain`."""
    B, H, D = q.shape
    out = flash_decode_plain(q.reshape(B * H, D), _fold(k, H), _fold(v, H),
                             valid, scale=scale)
    return out.reshape(B, H, -1)


def _check(q, k, v, valid, q_dims: int, kv_dims: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    if q.dim() != q_dims or k.dim() != kv_dims or v.dim() != kv_dims:
        raise ValueError(f"expected q {q_dims}-D and k, v {kv_dims}-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.shape[0] != k.shape[0] or k.shape[:-1] != v.shape[:-1]:
        raise ValueError(f"batch or cache shapes disagree: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] != k.shape[-1]:
        raise ValueError(f"q and k head dims differ: {q.shape[-1]} vs "
                         f"{k.shape[-1]}")
    if valid.shape != (k.shape[1],):
        raise ValueError(f"valid must be (L,) = ({k.shape[1]},), got "
                         f"{tuple(valid.shape)}")
    if len({t.device for t in (q, k, v, valid)}) != 1:
        raise ValueError("q, k, v and valid must lie on one device")


def _launch(q, k, v, valid, out, *, n_heads: int, group: int,
            strides_k: tuple, strides_v: tuple, scale: float) -> None:
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("k and v need unit stride along the head dim")
    D, Dv = q.shape[-1], v.shape[-1]
    if D > MAX_DIM or Dv > MAX_DIM:
        raise ValueError(f"head dims up to {MAX_DIM}, got D={D} Dv={Dv}")
    ok = (valid if valid.dtype == torch.bool else valid != 0).contiguous()
    fn = _build.function("flash_decode_launch", _ARGTYPES)
    rows, L = out.shape[0], k.shape[1]
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        ok.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype],
                        rows, n_heads, group, L, D, Dv, *strides_k,
                        *strides_v, float(scale), stream), SITE)
    dispatch.count_launch(SITE)
    dispatch.record(SITE, "cuda")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor, *,
                 scale: Optional[float] = None) -> torch.Tensor:
    """q (B, D) single-token queries against a KV cache k (B, L, D),
    v (B, L, Dv) with a shared (L,) validity mask -> (B, Dv) in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream or raise."""
    _check(q, k, v, valid, 2, 3)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        dispatch.record(SITE, "torch")
        return flash_decode_plain(q, k, v, valid, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = torch.empty((q.shape[0], v.shape[-1]), dtype=q.dtype,
                      device=q.device)
    if out.numel() == 0:
        dispatch.record(SITE, "cuda")
        return out
    sk, sv = k.stride(), v.stride()
    _launch(q, k, v, valid, out, n_heads=1, group=1,
            strides_k=(sk[0], sk[1], 0), strides_v=(sv[0], sv[1], 0),
            scale=scale)
    return out


def flash_decode_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, D) against the cache's own layout k (B, L, KV, D),
    v (B, L, KV, Dv), H a multiple of KV, with a shared (L,) validity
    mask -> (B, H, Dv) in q's dtype.  The same kernel and launch count as
    :func:`flash_decode`.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream or raise."""
    _check(q, k, v, valid, 3, 4)
    B, H, D = q.shape
    kv = k.shape[2]
    if H % kv:
        raise ValueError(f"{H} query heads do not share {kv} KV heads evenly")
    scale = scale if scale is not None else D ** -0.5
    if q.device.type == "cpu":
        dispatch.record(SITE, "torch")
        return flash_decode_gqa_plain(q, k, v, valid, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = torch.empty((B, H, v.shape[-1]), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        dispatch.record(SITE, "cuda")
        return out
    sk, sv = k.stride(), v.stride()
    _launch(q, k, v, valid, out.view(B * H, -1), n_heads=H, group=H // kv,
            strides_k=sk[:3], strides_v=sv[:3], scale=scale)
    return out
