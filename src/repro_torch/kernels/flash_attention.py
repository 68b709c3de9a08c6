"""Attention kernels: single-query decode over a KV cache
(``csrc/flash_decode.cu``) and full-sequence attention for training and
prefill (``csrc/flash_attention.cu``), each a hand-written CUDA kernel
beside its plain PyTorch version, as ``repro.kernels.flash_attention``
keeps ``flash_decode`` and ``flash_attention`` (Pallas TPU kernels).

Decode (site ``flash_decode``; body ``_decode_kernel`` in the reference):

  * :func:`flash_decode` takes the reference's folded layout, q (B, D)
    against k (B, L, D) and v (B, L, Dv);
  * :func:`flash_decode_gqa` takes the serving cache as it is stored,
    q (B, H, D) against k (B, L, KV, D) and v (B, L, KV, Dv), query head
    h reading KV head h // (H // KV): no repeat and no transpose of the
    cache (the reference folds both, ``attention.py:283-285``).

  Both take a shared (L,) validity mask (bool or int, nonzero = the slot
  takes part), accumulate in float32 and return q's dtype.  Masked slots
  contribute nothing; a row without a valid slot returns zeros, as the
  TPU kernel's re-zeroed probabilities give.  Any L is taken: the
  reference's caller gates on ``L % min(128, L) == 0`` (a TPU block
  constraint), the port does not.  The kernel splits a row's L slots
  over :func:`decode_splits` CTAs of one thread-block cluster and merges
  their partial states in rank order; :func:`flash_decode_split_plain`
  mirrors that on plain ops.

Full sequence (site ``flash_attention``; body ``_kernel``):

  * :func:`flash_attention_forward` returns the output and each row's
    float32 log-sum-exp, in the model's layout q (B, S, H, D),
    k (B, S, KV, D), v (B, S, KV, Dv) -> (B, S, H, Dv) and (B, H, S),
    read through strides with the head map h -> h // (H // KV);
  * :class:`FlashAttentionFn` makes it differentiable: the forward is
    the kernel (CUDA) or the plain version (CPU), the backward
    :func:`flash_attention_backward` is PyTorch ops on both devices (the
    JAX package differentiates attention with XLA's autodiff, outside any
    Pallas kernel);
  * :func:`flash_attention_gqa` is that function on the model's layout,
    :func:`flash_attention` on the reference's per-head (B, S, D) one.

  Causal or not, any S (the reference asserts ``S % bq == 0``, a TPU
  block constraint), head dims up to 256 with Dv free to differ from D.
  Scores and sums are float32 (float64 for float64 inputs on the CPU);
  the output has q's dtype.  The kernel has two variants, chosen by
  :func:`attention_variant` from dtype, head dims and layout:
  ``"wgmma"`` (bfloat16, (D, Dv) in :data:`WGMMA_DIMS`, which holds the
  pairs of the repo's bfloat16 models: 64 and 128 of the dense ones,
  256 of paligemma, 192 / 128 of MLA; tensors TMA can load: tensor
  cores, P rounded to bfloat16 before P V, within :func:`bf16_p_bound`
  of the plain version's float32 P) and ``"fp32"`` (everything else:
  float32 inputs, other head dims, strides TMA cannot take; CUDA cores,
  float32 products, any strides).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, dispatch

SITE = "flash_decode"
SITE_ATTN = "flash_attention"
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
MAX_DIM = 256                                # largest D and Dv the kernel takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5
             + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_ATTN_ARGTYPES = ([ctypes.c_void_p] * 5
                  + [ctypes.c_int] * 8
                  + [ctypes.c_longlong] * 9
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
#: decode: slots per CTA before a row's slots are split over another CTA
#: of its cluster, and the most CTAs a cluster has (the portable size)
SPLIT_SLOTS = 128
MAX_SPLITS = 8
#: full-sequence kernel variants, by their code in the C launcher
VARIANTS = ("fp32", "wgmma")
#: (D, Dv) head-dim pairs the wgmma variant takes; the C launcher
#: (``flash_attention_launch``) refuses any other for it
WGMMA_DIMS = frozenset({(64, 64), (128, 128), (192, 128), (256, 256)})
#: query rows per tile of the blocked backward: its score-sized
#: intermediates hold (H, BWD_TILE, S) floats per batch row
BWD_TILE = 512


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


def decode_splits(L: int) -> int:
    """CTAs (one thread-block cluster) the decode kernel gives one query
    row of an L-slot cache: one per ``SPLIT_SLOTS`` slots, at least 1 and
    at most ``MAX_SPLITS``.  A function of L alone, so the kernel's
    summation order, and with it its result, does not depend on the
    card."""
    return max(1, min(MAX_SPLITS, -(-L // SPLIT_SLOTS)))


def split_ranges(L: int, n_split: int) -> list[tuple[int, int]]:
    """The contiguous slot ranges [j0, j1) of the kernel's ``n_split``
    CTAs: ceil(L / n_split) slots each, the last one shorter."""
    chunk = -(-L // n_split)
    return [(min(L, r * chunk), min(L, (r + 1) * chunk))
            for r in range(n_split)]


def decode_partials_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, valid: torch.Tensor,
                          n_split: int, *, scale: Optional[float] = None):
    """Plain version of one decode cluster's CTAs: for each of the
    ``n_split`` slot ranges of :func:`split_ranges`, the partial state of
    q (B, D) against k (B, L, D), v (B, L, Dv) -> (m (n_split, B),
    l (n_split, B), acc (n_split, B, Dv)), float32.  A range without a
    valid slot has m = NEG_INF, l = 0 and acc = 0."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bd,bld->bl", q.float(), k.float()) * scale
    ok = (valid != 0)[None, :]
    ms, ls, accs = [], [], []
    for j0, j1 in split_ranges(k.shape[1], n_split):
        okr = ok[:, j0:j1]
        sr = torch.where(okr, s[:, j0:j1], NEG_INF)
        m = (sr.max(dim=-1).values if j1 > j0
             else s.new_full((q.shape[0],), NEG_INF))
        p = torch.where(okr, torch.exp(sr - m[:, None]), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bl,bld->bd", p, v[:, j0:j1].float()))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def merge_partials_plain(m: torch.Tensor, l: torch.Tensor,
                         acc: torch.Tensor) -> torch.Tensor:
    """Merge the partial states of :func:`decode_partials_plain` in rank
    order, as the cluster's rank 0 does -> (B, Dv) float32.  A range
    with l = 0 (every slot masked, m = NEG_INF) gets weight 0, whatever
    its acc holds: with every range masked, exp(m - max) would be 1."""
    top = m.max(dim=0).values
    w = torch.where(l > 0, torch.exp(m - top), 0.0)
    lt = torch.zeros_like(top)
    out = torch.zeros_like(acc[0])
    for r in range(m.shape[0]):
        lt = lt + w[r] * l[r]
        out = out + w[r][:, None] * acc[r]
    return out / torch.clamp(lt, min=1e-30)[:, None]


def flash_decode_split_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, valid: torch.Tensor, *,
                             n_split: Optional[int] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """:func:`flash_decode_plain` computed as the kernel splits it: per
    slot range, then merged in rank order (``n_split`` defaults to
    :func:`decode_splits` of L) -> (B, Dv) in q's dtype."""
    n = decode_splits(k.shape[1]) if n_split is None else n_split
    out = merge_partials_plain(*decode_partials_plain(q, k, v, valid, n,
                                                      scale=scale))
    return out.to(q.dtype)


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
    rows, L = out.shape[0], k.shape[1]
    _build.launch("flash_decode_launch", _ARGTYPES, SITE, q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), ok.data_ptr(),
                  out.data_ptr(), DTYPE_CODES[q.dtype], rows, n_heads, group,
                  L, D, Dv, *strides_k, *strides_v, float(scale),
                  decode_splits(L))


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor, *,
                 scale: Optional[float] = None) -> torch.Tensor:
    """q (B, D) single-token queries against a KV cache k (B, L, D),
    v (B, L, Dv) with a shared (L,) validity mask -> (B, Dv) in q's dtype.

    CPU and meta tensors take the plain version; CUDA tensors launch the
    kernel on the current stream or raise."""
    _check(q, k, v, valid, 2, 3)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if dispatch.plain(q.device, SITE):
        return flash_decode_plain(q, k, v, valid, scale=scale)
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

    CPU and meta tensors take the plain version; CUDA tensors launch the
    kernel on the current stream or raise."""
    _check(q, k, v, valid, 3, 4)
    B, H, D = q.shape
    kv = k.shape[2]
    if H % kv:
        raise ValueError(f"{H} query heads do not share {kv} KV heads evenly")
    scale = scale if scale is not None else D ** -0.5
    if dispatch.plain(q.device, SITE):
        return flash_decode_gqa_plain(q, k, v, valid, scale=scale)
    out = torch.empty((B, H, v.shape[-1]), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        dispatch.record(SITE, "cuda")
        return out
    sk, sv = k.stride(), v.stride()
    _launch(q, k, v, valid, out.view(B * H, -1), n_heads=H, group=H // kv,
            strides_k=sk[:3], strides_v=sv[:3], scale=scale)
    return out


# ============================================================ full sequence
def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """float64 stays float64 (gradient checks on the CPU); everything
    else computes in float32, as the kernel does."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _by_group(t: torch.Tensor, kv: int, dtype: torch.dtype) -> torch.Tensor:
    """(B, S, H, X) -> (B, KV, g, S, X) in ``dtype``, g = H // KV: query
    heads j g .. j g + g - 1 share KV head j."""
    B, S, H, X = t.shape
    return t.to(dtype).reshape(B, S, kv, H // kv, X).permute(0, 2, 3, 1, 4)


def _ungroup(t: torch.Tensor) -> torch.Tensor:
    """(B, KV, g, S, X) -> (B, S, KV * g, X)."""
    B, kv, g, S, X = t.shape
    return t.permute(0, 3, 1, 2, 4).reshape(B, S, kv * g, X)


def _causal_keep(sq: int, sk: int, *, offset: int = 0,
                device=None) -> torch.Tensor:
    """(sq, sk) bool: query row i (absolute position i + offset) may see
    key j <= i + offset."""
    rows = torch.arange(sq, device=device)[:, None] + offset
    return rows >= torch.arange(sk, device=device)[None, :]


def flash_attention_forward_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, causal: bool = True,
                                  scale: Optional[float] = None):
    """Plain PyTorch version of :func:`flash_attention_forward`:
    q (B, S, H, D), k (B, S, KV, D), v (B, S, KV, Dv) -> (out
    (B, S, H, Dv) in q's dtype, lse (B, H, S)), scores and sums in float32
    (float64 for float64 inputs), the probabilities normalised after P·V
    as the kernel's online softmax does."""
    B, S, H, D = q.shape
    kv = k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    ct = _compute_dtype(q.dtype)
    qg = _by_group(q, kv, ct)                           # (B, KV, g, S, D)
    kk = k.to(ct).transpose(1, 2)[:, :, None]           # (B, KV, 1, S, D)
    vv = v.to(ct).transpose(1, 2)[:, :, None]
    s = torch.matmul(qg, kk.transpose(-1, -2)) * scale  # (B, KV, g, S, S)
    if causal:
        s = torch.where(_causal_keep(S, S, device=q.device), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)                 # masked: exp(NEG_INF - m) = 0
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = _ungroup(torch.matmul(p, vv) / l).to(q.dtype)
    lse = (m + torch.log(l))[..., 0].reshape(B, H, S)
    return out, lse


def bf16_p_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Per output element (B, S, H, Dv), float32: 2^-7 (Sum_j p_j |v_j|)
    / l, twice the most that rounding each probability to bfloat16 before
    P V can move the output (the bfloat16 unit roundoff is 2^-8), which
    the wgmma kernel does and :func:`flash_attention_forward_plain` does
    not."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    B, S, H, D = q.shape
    kv = k.shape[2]
    qg = _by_group(q, kv, torch.float32)
    kk = k.float().transpose(1, 2)[:, :, None]
    vv = v.float().abs().transpose(1, 2)[:, :, None]
    s = torch.matmul(qg, kk.transpose(-1, -2)) * scale
    if causal:
        s = torch.where(_causal_keep(S, S, device=q.device), s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return 2.0 ** -7 * _ungroup(torch.matmul(p, vv) / l)


def _check_attn(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected q (B, S, H, D), k (B, S, KV, D), "
                         f"v (B, S, KV, Dv), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not q.dtype.is_floating_point:
        raise TypeError(f"q must be floating point, got {q.dtype}")
    B, S, H, D = q.shape
    if (k.shape[:2] != (B, S) or v.shape[:3] != k.shape[:3]
            or k.shape[3] != D):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"{H} query heads do not share {k.shape[2]} KV "
                         f"heads evenly")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k and v must lie on one device")


def _strides(t: torch.Tensor) -> tuple:
    """t's (batch, position, head) element strides, a size-1 dim given
    the stride it would have on top of the dim below it: no element is
    read through it, and TMA takes only 16-byte multiples."""
    st = list(t.stride())
    for i in (2, 1, 0):
        if t.shape[i] == 1:
            st[i] = st[i + 1] * t.shape[i + 1]
    return tuple(st[:3])


def _tma_ready(t: torch.Tensor) -> bool:
    """TMA can load bf16 ``t``: a 16-byte aligned base, and strides of
    multiples of 8 elements."""
    return t.data_ptr() % 16 == 0 and all(
        s >= 1 and s % 8 == 0 for s in _strides(t))


def attention_variant(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> str:
    """The full-sequence kernel's variant for these inputs: ``"wgmma"``
    for bfloat16 with (D, Dv) in :data:`WGMMA_DIMS` that TMA can load
    (:func:`_tma_ready`), else ``"fp32"``, which reads through any
    strides.  A choice from the inputs alone, never because something
    failed: the wrapper passes it to the C launcher, which checks it."""
    return ("wgmma" if q.dtype == torch.bfloat16
            and (q.shape[-1], v.shape[-1]) in WGMMA_DIMS
            and all(map(_tma_ready, (q, k, v))) else "fp32")


def _attention_cuda(q, k, v, causal: bool, scale: float,
                    variant: Optional[str] = None):
    """Launch the kernel in ``variant`` (default :func:`attention_variant`;
    another is asked only to time one variant against the other, and
    the C launcher refuses it where the inputs do not allow it)."""
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k and v need unit stride along the head dim")
    B, S, H, D = q.shape
    kv, Dv = k.shape[2], v.shape[-1]
    if D > MAX_DIM or Dv > MAX_DIM:
        raise ValueError(f"head dims up to {MAX_DIM}, got D={D} Dv={Dv}")
    dev = q.device
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        dispatch.record(SITE_ATTN, "cuda")
        return out, lse
    variant = variant or attention_variant(q, k, v)
    _build.launch("flash_attention_launch", _ATTN_ARGTYPES, SITE_ATTN, dev,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), DTYPE_CODES[q.dtype], B, S, H, H // kv, D,
                  Dv, int(causal), *_strides(q), *_strides(k), *_strides(v),
                  float(scale), VARIANTS.index(variant), variant=variant)
    return out, lse


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            scale: Optional[float] = None):
    """q (B, S, H, D), k (B, S, KV, D), v (B, S, KV, Dv), H a multiple of
    KV -> (out (B, S, H, Dv) in q's dtype, lse (B, H, S) float32 on the
    card), without autograd.

    CPU and meta tensors take the plain version; CUDA tensors launch the
    kernel on the current stream or raise."""
    _check_attn(q, k, v)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if dispatch.plain(q.device, SITE_ATTN):
        return flash_attention_forward_plain(q, k, v, causal=causal,
                                             scale=scale)
    return _attention_cuda(q, k, v, causal, scale)


def flash_attention_backward(q, k, v, out, lse, dout, *, causal: bool,
                             scale: float):
    """Gradients of attention from the forward's saved tensors, in
    PyTorch ops on either device: (dq, dk, dv) in the inputs' dtypes.

    Over query tiles of ``BWD_TILE`` rows, in order: delta = rowsum(dO * O),
    P = exp(s - lse) under the mask, dV += P^T dO, dP = dO V^T,
    dS = P * (dP - delta), dQ = scale dS K, dK += scale dS^T Q.  The g
    query heads of a KV head are rows of one product, so dK and dV sum
    over them inside it.  Memory stays O(S * tile) per head, and every
    sum runs in a fixed order (deterministic)."""
    B, S, H, D = q.shape
    kv, Dv = k.shape[2], v.shape[-1]
    g = H // kv
    tile = BWD_TILE
    ct = _compute_dtype(q.dtype)
    qg, og, dog = (_by_group(t, kv, ct) for t in (q, out, dout))
    kk = k.to(ct).transpose(1, 2)                       # (B, KV, S, D)
    vv = v.to(ct).transpose(1, 2)                       # (B, KV, S, Dv)
    lse_g = lse.to(ct).reshape(B, kv, g, S)
    delta = (dog * og).sum(dim=-1)                      # (B, KV, g, S)
    dq = torch.empty_like(qg)
    dk = torch.zeros_like(kk)
    dv = torch.zeros_like(vv)
    for t0 in range(0, S, tile):
        t1 = min(S, t0 + tile)
        T, n = t1 - t0, (t1 if causal else S)
        qt = qg[:, :, :, t0:t1].reshape(B, kv, g * T, D)
        dot = dog[:, :, :, t0:t1].reshape(B, kv, g * T, Dv)
        kt, vt = kk[:, :, :n], vv[:, :, :n]
        s = torch.matmul(qt, kt.transpose(-1, -2)) * scale   # (B,KV,gT,n)
        p = torch.exp(s - lse_g[..., t0:t1].reshape(B, kv, g * T, 1))
        if causal:
            keep = _causal_keep(T, n, offset=t0, device=q.device).repeat(g, 1)
            p = torch.where(keep, p, 0.0)
        dp = torch.matmul(dot, vt.transpose(-1, -2))
        ds = p * (dp - delta[..., t0:t1].reshape(B, kv, g * T, 1))
        dq[:, :, :, t0:t1] = (torch.matmul(ds, kt) * scale).reshape(
            B, kv, g, T, D)
        dk[:, :, :n] += torch.matmul(ds.transpose(-1, -2), qt) * scale
        dv[:, :, :n] += torch.matmul(p.transpose(-1, -2), dot)
    return (_ungroup(dq).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable full-sequence attention: the forward is
    :func:`flash_attention_forward` (the kernel on CUDA tensors, the plain
    version on CPU tensors), the backward :func:`flash_attention_backward`
    from the saved q, k, v, output and log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_attention_forward(q, k, v, causal=causal,
                                           scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q (B, S, H, D), k (B, S, KV, D), v (B, S, KV, Dv) -> (B, S, H, Dv)
    in q's dtype, differentiable (:class:`FlashAttentionFn`).  K and V
    are read in place, query head h using KV head h // (H // KV).

    CPU and meta tensors take the plain version; CUDA tensors launch the
    kernel on the current stream or raise."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return FlashAttentionFn.apply(q, k, v, causal, scale)


def flash_attention_gqa_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Plain version of :func:`flash_attention_gqa`, differentiated by
    autograd through its own ops."""
    return flash_attention_forward_plain(q, k, v, causal=causal,
                                         scale=scale)[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The reference's per-head layout: q, k (B, S, D), v (B, S, Dv) ->
    (B, S, Dv) in q's dtype, differentiable; one head of
    :func:`flash_attention_gqa`."""
    return flash_attention_gqa(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal, scale=scale)[:, :, 0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`flash_attention` (``ref.attention``)."""
    return flash_attention_gqa_plain(q[:, :, None], k[:, :, None],
                                     v[:, :, None], causal=causal,
                                     scale=scale)[:, :, 0]
