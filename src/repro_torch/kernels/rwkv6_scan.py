"""RWKV6 (WKV) recurrence: the hand-written CUDA kernels
(``csrc/wkv6.cu``) and their plain PyTorch versions.

    S_t = diag(w_t) S_{t-1} + k_t v_t^T ;  y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

Counterparts of ``repro.kernels.rwkv6_scan`` (Pallas TPU kernels):

  * :func:`wkv6_decode` — one step for every (batch, head) row (site
    ``wkv6_decode``; the serving decode step);
  * :func:`wkv6_batched` — T steps in chunks (site ``wkv6_batched``; the
    serving prefill), and :func:`wkv6`, its single-head wrapper.

The chunked form differs from the reference's on purpose.  The TPU kernel
forms ``k * exp(-cumsum(log w))``, which overflows float32 under strong
decay (w = 0.06 over a 32-row chunk gives errors of order 10, w = 0.01
NaN).  Here each in-chunk pair (t, s < t) carries its own decay
``exp(la[t-1] - la[s])``, a product of decays and so at most 1, and the
cross and state terms use ``exp(la[t-1])`` and ``exp(la[c-1] - la[s])``,
also at most 1: nothing overflows.  Where the reference is finite the two
agree within float32 rounding.  The last chunk may be shorter than the
others, so any T is taken (the reference's caller shrinks the chunk
until it divides T, down to 1 for a prime T).

Both kernels may write the new state over the old one (``out_state``),
which the serving path uses to keep its state preallocated.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, dispatch

SITE_DECODE = "wkv6_decode"
SITE_BATCHED = "wkv6_batched"
CHUNK = 32
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232_448                 # bytes of shared memory a CTA may use
_P = ctypes.c_void_p
_DECODE_ARGTYPES = [_P] * 8 + [ctypes.c_int] * 4 + [_P]
_BATCHED_ARGTYPES = [_P] * 8 + [ctypes.c_int] * 6 + [_P]


# ------------------------------------------------------------ plain versions
def wkv6_decode_plain(r, k, v, w, u, state):
    """One step: r, k, w, u (BH, dk); v (BH, dv); state (BH, dk, dv)
    float32 -> (y (BH, dv) float32, new state (BH, dk, dv) float32)."""
    S = state.float()
    kv = k.float()[:, :, None] * v.float()[:, None, :]
    y = (r.float()[:, :, None] * (S + u.float()[:, :, None] * kv)).sum(1)
    return y, w.float()[:, :, None] * S + kv


def wkv6_batched_plain(r, k, v, w, u, state, *, chunk: int = CHUNK):
    """T steps in chunks of ``chunk`` (the last may be shorter), the
    pairwise form of the module docstring: r, k, w (BH, T, dk);
    v (BH, T, dv); u (BH, dk); state (BH, dk, dv) float32 ->
    (y (BH, T, dv) float32, final state (BH, dk, dv) float32)."""
    BH, T, dk = r.shape
    S = state.float()
    uf = u.float()
    ys = []
    for t0 in range(0, T, chunk):
        c = min(chunk, T - t0)
        rr, kk, vv, ww = (x[:, t0:t0 + c].float() for x in (r, k, v, w))
        la = torch.cumsum(torch.log(torch.clamp(ww, min=1e-38)), dim=1)
        la_prev = torch.cat([torch.zeros_like(la[:, :1]), la[:, :-1]], 1)
        below = torch.ones(c, c, dtype=torch.bool,
                           device=r.device).tril(-1)[None, :, :, None]
        diff = la_prev[:, :, None, :] - la[:, None, :, :]   # (BH, t, s, dk)
        decay = torch.exp(torch.where(below, diff, -torch.inf))
        A = torch.einsum("bti,bsi,btsi->bts", rr, kk, decay)
        A = A + torch.diag_embed((rr * uf[:, None, :] * kk).sum(-1))
        ys.append(A @ vv + (rr * torch.exp(la_prev)) @ S)
        tail = kk * torch.exp(la[:, -1:] - la)               # (BH, c, dk)
        S = torch.exp(la[:, -1])[:, :, None] * S + tail.transpose(1, 2) @ vv
    return torch.cat(ys, dim=1), S


# ------------------------------------------------------------------ checks
def _check(r, k, v, w, u, state, *, steps: bool) -> None:
    names = ("r", "k", "v", "w", "u", "state")
    for name, t in zip(names, (r, k, v, w, u, state)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    if r.dtype not in DTYPE_CODES:
        raise TypeError(f"r must be float32 or bfloat16, got {r.dtype}")
    for name, t in zip(names[1:5], (k, v, w, u)):
        if t.dtype != r.dtype:
            raise TypeError(f"{name} is {t.dtype}, r is {r.dtype}: r, k, v, "
                            f"w and u must share a dtype")
    if state.dtype != torch.float32:
        raise TypeError(f"state must be float32, got {state.dtype}")
    lead = 3 if steps else 2
    if r.dim() != lead or k.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"r, k, w must be {lead}-D of one shape, got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(w.shape)}")
    BH, dk = r.shape[0], r.shape[-1]
    if v.dim() != lead or v.shape[:-1] != r.shape[:-1]:
        raise ValueError(f"v {tuple(v.shape)} does not match r "
                         f"{tuple(r.shape)}")
    if u.shape != (BH, dk) or state.shape != (BH, dk, v.shape[-1]):
        raise ValueError(f"u must be ({BH}, {dk}) and state ({BH}, {dk}, "
                         f"{v.shape[-1]}), got {tuple(u.shape)}, "
                         f"{tuple(state.shape)}")
    if len({t.device for t in (r, k, v, w, u, state)}) != 1:
        raise ValueError("all inputs must lie on one device")


def _out_state(state, out_state):
    if out_state is None:
        return torch.empty_like(state)
    if (out_state.shape != state.shape or out_state.dtype != torch.float32
            or out_state.device != state.device
            or not out_state.is_contiguous()):
        raise ValueError("out_state must be a contiguous float32 tensor "
                         "shaped and placed like state")
    return out_state


def _contiguous(*ts) -> None:
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the CUDA kernels take contiguous inputs")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# ----------------------------------------------------------------- wrappers
def wkv6_decode(r, k, v, w, u, state, *,
                out_state: Optional[torch.Tensor] = None):
    """One WKV6 step for every row: r, k, w, u (BH, dk); v (BH, dv);
    state (BH, dk, dv) float32 -> (y (BH, dv) float32, new state).  The
    new state goes to ``out_state`` when given (it may be ``state``
    itself), else to a new tensor.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream or raise."""
    _check(r, k, v, w, u, state, steps=False)
    dev = r.device
    if dev.type == "cpu":
        dispatch.record(SITE_DECODE, "torch")
        y, new = wkv6_decode_plain(r, k, v, w, u, state)
        if out_state is None:
            return y, new
        return y, _out_state(state, out_state).copy_(new)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _contiguous(r, k, v, w, u, state)
    BH, dk = r.shape
    dv = v.shape[-1]
    dst = _out_state(state, out_state)
    y = torch.empty((BH, dv), dtype=torch.float32, device=dev)
    if BH and dk and dv:
        fn = _build.function("wkv6_decode_launch", _DECODE_ARGTYPES)
        with torch.cuda.device(dev):
            _build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                            w.data_ptr(), u.data_ptr(), state.data_ptr(),
                            y.data_ptr(), dst.data_ptr(),
                            DTYPE_CODES[r.dtype], BH, dk, dv, _stream(dev)),
                         SITE_DECODE)
        dispatch.count_launch(SITE_DECODE)
    dispatch.record(SITE_DECODE, "cuda")
    return y, dst


def _batched_smem(dk: int, dv: int, chunk: int) -> int:
    """Dynamic shared memory (bytes) of one ``wkv6_batched`` CTA, as
    ``wkv6_batched_smem`` in ``csrc/wkv6.cu`` computes it."""
    return 4 * (chunk * (3 * (dk + 1) + dv) + dk * dv + chunk * chunk
                + 2 * dk)


def wkv6_batched(r, k, v, w, u, state, *, chunk: int = CHUNK,
                 out_state: Optional[torch.Tensor] = None):
    """Chunked WKV6 over every (batch, head) row — the prefill entry.
    r, k, w (BH, T, dk); v (BH, T, dv); u (BH, dk); state (BH, dk, dv)
    float32 -> (y (BH, T, dv) float32, final state (BH, dk, dv) float32).
    Any T: the last chunk may be shorter.  The final state goes to
    ``out_state`` when given (it may be ``state`` itself).

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream or raise."""
    _check(r, k, v, w, u, state, steps=True)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    dev = r.device
    if dev.type == "cpu":
        dispatch.record(SITE_BATCHED, "torch")
        y, new = wkv6_batched_plain(r, k, v, w, u, state, chunk=chunk)
        if out_state is None:
            return y, new
        return y, _out_state(state, out_state).copy_(new)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _contiguous(r, k, v, w, u, state)
    BH, T, dk = r.shape
    dv = v.shape[-1]
    smem = _batched_smem(dk, dv, chunk)
    if smem > MAX_SMEM:
        raise ValueError(f"dk={dk}, dv={dv}, chunk={chunk} need {smem} B "
                         f"of shared memory, above the {MAX_SMEM} B a CTA "
                         f"may use")
    dst = _out_state(state, out_state)
    y = torch.empty((BH, T, dv), dtype=torch.float32, device=dev)
    if BH and dk and dv:
        fn = _build.function("wkv6_batched_launch", _BATCHED_ARGTYPES)
        with torch.cuda.device(dev):
            _build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                            w.data_ptr(), u.data_ptr(), state.data_ptr(),
                            y.data_ptr(), dst.data_ptr(),
                            DTYPE_CODES[r.dtype], BH, T, dk, dv, chunk,
                            _stream(dev)), SITE_BATCHED)
        dispatch.count_launch(SITE_BATCHED)
    dispatch.record(SITE_BATCHED, "cuda")
    return y, dst


def wkv6(r, k, v, w, u, state, *, chunk: int = CHUNK):
    """Single-head wrapper of :func:`wkv6_batched`: r, k, w (T, dk);
    v (T, dv); u (dk,); state (dk, dv) -> (y (T, dv) in r's dtype,
    final state float32)."""
    y, final = wkv6_batched(r[None], k[None], v[None], w[None], u[None],
                            state[None].float().contiguous(), chunk=chunk)
    return y[0].to(r.dtype), final[0]


def wkv6_plain(r, k, v, w, u, state, *, chunk: int = CHUNK):
    """Plain version of :func:`wkv6`."""
    y, final = wkv6_batched_plain(r[None], k[None], v[None], w[None],
                                  u[None], state[None].float(), chunk=chunk)
    return y[0].to(r.dtype), final[0]
