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

Training differentiates the chunked form through :class:`WKV6BatchedFn`:
its forward is :func:`wkv6_batched` (the kernel on CUDA tensors, the
plain version on CPU tensors), its backward :func:`wkv6_batched_backward`,
PyTorch ops on both devices (the JAX package differentiates its jnp
chunked form with XLA's autodiff and has no backward kernel).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, dispatch
from repro_torch.trips import full, trips

SITE_DECODE = "wkv6_decode"
SITE_BATCHED = "wkv6_batched"
CHUNK = 32
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232_448                 # bytes of shared memory a CTA may use
#: CTAs the column split aims for (two a streaming multiprocessor of the
#: H100), the fewest state columns a CTA keeps, and the most CTAs a head
#: is split over (the portable thread-block cluster size)
TARGET_CTAS = 2 * 132
MIN_COLS = 8
MAX_COLS_SPLIT = 8
#: state rows whose y terms one decode thread sums into one partial
ROW_GROUP = 4
#: threads of a wkv6_batched CTA (csrc/wkv6.cu kBatchedThreads)
BATCHED_THREADS = 256
_P = ctypes.c_void_p
_DECODE_ARGTYPES = [_P] * 8 + [ctypes.c_int] * 5 + [_P]
_BATCHED_ARGTYPES = [_P] * 8 + [ctypes.c_int] * 7 + [_P]


# ------------------------------------------------------------ column split
def col_split(BH: int, dv: int) -> int:
    """CTAs each (batch, head) row's dv state columns are split over, in
    both kernels: doubled from 1 while BH x n_col is under TARGET_CTAS,
    each CTA keeps at least MIN_COLS columns and n_col divides dv, up to
    MAX_COLS_SPLIT (one cluster).  A function of the shapes alone, so the
    kernels' summation order, and with it their results, does not depend
    on the card."""
    n = 1
    while (BH * n < TARGET_CTAS and 2 * n <= MAX_COLS_SPLIT
           and dv % (2 * n) == 0 and dv // (2 * n) >= MIN_COLS):
        n *= 2
    return n


def col_ranges(dv: int, n_col: int) -> list[tuple[int, int]]:
    """The state columns [j0, j1) of each of a row's ``n_col`` CTAs."""
    cw = dv // n_col
    return [(r * cw, (r + 1) * cw) for r in range(n_col)]


def pair_ranges(c: int, n_col: int) -> list[tuple[int, int]]:
    """The pairs of a c-row chunk's matrix A that each rank of a
    ``wkv6_batched`` cluster computes: pair p = t (t + 1) / 2 + s numbers
    (t, s <= t) row by row, and rank r takes the p in its range
    [p0, p1), ceil(P / n_col) pairs each (P = c (c + 1) / 2), the last
    ones shorter."""
    P = c * (c + 1) // 2
    per = -(-P // n_col)
    return [(min(P, r * per), min(P, (r + 1) * per)) for r in range(n_col)]


def pair_of(p: int) -> tuple[int, int]:
    """(t, s) of pair number p."""
    t = int(((8 * p + 1) ** 0.5 - 1) / 2)
    while t * (t + 1) // 2 > p:
        t -= 1
    while (t + 1) * (t + 2) // 2 <= p:
        t += 1
    return t, p - t * (t + 1) // 2


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
    n = -(-T // chunk)
    for i in trips(n):
        t0 = i * chunk
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
    return torch.cat(full(ys, n), dim=1)[:, :T], S


# --------------------------------------------- mirrors of the kernels' split
# Used by the tests: the kernels' decomposition on plain ops, held against
# the plain versions above (the same terms, summed in another order).
def wkv6_decode_split_plain(r, k, v, w, u, state, *,
                            n_col: Optional[int] = None):
    """:func:`wkv6_decode_plain` as the kernel splits it: each of the
    ``n_col`` CTAs of a row (default :func:`col_split`) takes the state
    columns of :func:`col_ranges`; y_j sums its rows' terms in groups of
    ROW_GROUP rows, each group in row order, and the groups' partials in
    group order."""
    BH, dk = r.shape
    dv = v.shape[-1]
    n_col = col_split(BH, dv) if n_col is None else n_col
    rf, kf, vf, wf, uf = (x.float() for x in (r, k, v, w, u))
    S = state.float()
    ys, news = [], []
    for j0, j1 in col_ranges(dv, n_col):
        Sj = S[:, :, j0:j1]
        kv = kf[:, :, None] * vf[:, None, j0:j1]
        terms = rf[:, :, None] * (Sj + uf[:, :, None] * kv)
        y = torch.zeros_like(terms[:, 0])
        for g0 in range(0, dk, ROW_GROUP):
            part = torch.zeros_like(y)
            for i in range(g0, min(dk, g0 + ROW_GROUP)):
                part = part + terms[:, i]
            y = y + part
        ys.append(y)
        news.append(wf[:, :, None] * Sj + kv)
    return torch.cat(ys, 1), torch.cat(news, 2)


def pairwise_plain(rr, kk, uf, la, la_prev, n_col: int):
    """One chunk's matrix A (BH, c, c), lower triangle and diagonal, as a
    ``wkv6_batched`` cluster computes it: rank by rank, each its pairs of
    :func:`pair_ranges`, every pair once."""
    BH, c, _ = rr.shape
    A = rr.new_zeros((BH, c, c))
    for p0, p1 in pair_ranges(c, n_col):
        if p0 == p1:
            continue
        t, s = (torch.tensor(x) for x in zip(*map(pair_of, range(p0, p1))))
        diag = (t == s)[None, :, None]
        decay = torch.exp(torch.where(diag, 0.0,
                                      la_prev[:, t] - la[:, s]))
        A[:, t, s] = (rr[:, t] * kk[:, s]
                      * torch.where(diag, uf[:, None, :], decay)).sum(-1)
    return A


def wkv6_batched_split_plain(r, k, v, w, u, state, *, chunk: int = CHUNK,
                             n_col: Optional[int] = None):
    """:func:`wkv6_batched_plain` as the kernel splits it: a row's
    ``n_col`` CTAs (default :func:`col_split`) share one matrix A a chunk,
    each rank computing its pairs (:func:`pairwise_plain`), and each CTA
    computes y and the carried state for its columns of
    :func:`col_ranges` alone."""
    BH, T, dk = r.shape
    dv = v.shape[-1]
    n_col = col_split(BH, dv) if n_col is None else n_col
    S = state.float()
    uf = u.float()
    ys = []
    for t0 in range(0, T, chunk):
        c = min(chunk, T - t0)
        rr, kk, vv, ww = (x[:, t0:t0 + c].float() for x in (r, k, v, w))
        la = torch.cumsum(torch.log(torch.clamp(ww, min=1e-38)), dim=1)
        la_prev = torch.cat([torch.zeros_like(la[:, :1]), la[:, :-1]], 1)
        A = pairwise_plain(rr, kk, uf, la, la_prev, n_col)
        rh = rr * torch.exp(la_prev)
        tail = (kk * torch.exp(la[:, -1:] - la)).transpose(1, 2)
        dec = torch.exp(la[:, -1])[:, :, None]
        y_cols, s_cols = [], []
        for j0, j1 in col_ranges(dv, n_col):
            vj, Sj = vv[:, :, j0:j1], S[:, :, j0:j1]
            y_cols.append(A @ vj + rh @ Sj)
            s_cols.append(dec * Sj + tail @ vj)
        ys.append(torch.cat(y_cols, 2))
        S = torch.cat(s_cols, 2)
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


# ----------------------------------------------------------------- wrappers
def wkv6_decode(r, k, v, w, u, state, *,
                out_state: Optional[torch.Tensor] = None):
    """One WKV6 step for every row: r, k, w, u (BH, dk); v (BH, dv);
    state (BH, dk, dv) float32 -> (y (BH, dv) float32, new state).  The
    new state goes to ``out_state`` when given (it may be ``state``
    itself), else to a new tensor.

    CPU and meta tensors take the plain version; CUDA tensors launch the
    kernel on the current stream or raise."""
    _check(r, k, v, w, u, state, steps=False)
    dev = r.device
    if dispatch.plain(dev, SITE_DECODE):
        y, new = wkv6_decode_plain(r, k, v, w, u, state)
        if out_state is None:
            return y, new
        return y, _out_state(state, out_state).copy_(new)
    _contiguous(r, k, v, w, u, state)
    BH, dk = r.shape
    dv = v.shape[-1]
    dst = _out_state(state, out_state)
    y = torch.empty((BH, dv), dtype=torch.float32, device=dev)
    if not (BH and dk and dv):
        dispatch.record(SITE_DECODE, "cuda")
        return y, dst
    _build.launch("wkv6_decode_launch", _DECODE_ARGTYPES, SITE_DECODE, dev,
                  r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  u.data_ptr(), state.data_ptr(), y.data_ptr(),
                  dst.data_ptr(), DTYPE_CODES[r.dtype], BH, dk, dv,
                  col_split(BH, dv))
    return y, dst


def _batched_smem(dk: int, dv: int, chunk: int, n_col: int,
                  itemsize: int) -> int:
    """Dynamic shared memory (bytes) of one ``wkv6_batched`` CTA, as
    ``wkv6_batched_smem`` in ``csrc/wkv6.cu`` computes it: two stages of
    a chunk's raw r, k, w (chunk x dk) and v (chunk x its dv / n_col
    columns), then float32: the state twice and v (columns padded to 4),
    r, k, log decay, r under decay and the k tail (chunk x (dk + 1)
    each), A twice (by chunk parity, rows of chunk + 1), u, the chunk's
    decay, and the row blocks' log-decay totals (BATCHED_THREADS // dk
    blocks a column)."""
    cw = dv // n_col
    cwp = -(-cw // 4) * 4
    stage = -(-itemsize * (3 * chunk * dk + chunk * cw) // 16) * 16
    blocks = BATCHED_THREADS // dk * dk if dk < BATCHED_THREADS else dk
    return 2 * stage + 4 * (2 * dk * cwp + chunk * cwp
                            + 5 * chunk * (dk + 1) + 2 * chunk * (chunk + 1)
                            + 2 * dk + blocks)


def wkv6_batched(r, k, v, w, u, state, *, chunk: int = CHUNK,
                 out_state: Optional[torch.Tensor] = None):
    """Chunked WKV6 over every (batch, head) row — the prefill entry.
    r, k, w (BH, T, dk); v (BH, T, dv); u (BH, dk); state (BH, dk, dv)
    float32 -> (y (BH, T, dv) float32, final state (BH, dk, dv) float32).
    Any T: the last chunk may be shorter.  The final state goes to
    ``out_state`` when given (it may be ``state`` itself).

    CPU and meta tensors take the plain version; CUDA tensors launch the
    kernel on the current stream or raise."""
    _check(r, k, v, w, u, state, steps=True)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    dev = r.device
    if dispatch.plain(dev, SITE_BATCHED):
        y, new = wkv6_batched_plain(r, k, v, w, u, state, chunk=chunk)
        if out_state is None:
            return y, new
        return y, _out_state(state, out_state).copy_(new)
    _contiguous(r, k, v, w, u, state)
    BH, T, dk = r.shape
    dv = v.shape[-1]
    n_col = col_split(BH, dv)
    smem = _batched_smem(dk, dv, chunk, n_col, r.element_size())
    if smem > MAX_SMEM:
        raise ValueError(f"dk={dk}, dv={dv}, chunk={chunk} need {smem} B "
                         f"of shared memory, above the {MAX_SMEM} B a CTA "
                         f"may use")
    dst = _out_state(state, out_state)
    y = torch.empty((BH, T, dv), dtype=torch.float32, device=dev)
    if not (BH and dk and dv):
        dispatch.record(SITE_BATCHED, "cuda")
        return y, dst
    _build.launch("wkv6_batched_launch", _BATCHED_ARGTYPES, SITE_BATCHED,
                  dev, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  u.data_ptr(), state.data_ptr(), y.data_ptr(),
                  dst.data_ptr(), DTYPE_CODES[r.dtype], BH, T, dk, dv, chunk,
                  n_col)
    return y, dst


# ----------------------------------------------------------------- gradient
#: elements of the pairwise decay tensor (chunks, c, c, dk) that the
#: backward forms at once: it takes the chunks in groups of about this
#: size (256 MiB in float32)
BWD_PAIR_ELEMS = 1 << 26


def _affine_scan(d, b):
    """x_i = d_i x_{i-1} + b_i along axis 1 from x_{-1} = 0, every i at
    once: log2(n) rounds (Kogge-Stone), round k composing the maps 2^k
    chunks apart.  d (BH, n, dk, 1) are products of decays, at most 1, so
    nothing grows; b (BH, n, dk, dv)."""
    off, n = 1, b.shape[1]
    while off < n:
        b = torch.cat([b[:, :off],
                       torch.addcmul(b[:, off:], d[:, off:], b[:, :-off])], 1)
        if 2 * off < n:
            d = torch.cat([d[:, :off], d[:, off:] * d[:, :-off]], 1)
        off *= 2
    return b


@torch.no_grad()
def wkv6_batched_backward(r, k, v, w, u, state, dy, dstate=None, *,
                          chunk: int = CHUNK):
    """Gradients of :func:`wkv6_batched` from its inputs and the
    gradients of its outputs, in PyTorch ops on either device:
    (dr, dk, dv, dw, du) in the inputs' dtype and d state float32.
    ``dy`` (BH, T, dv) and ``dstate`` (BH, dk, dv) may be None (no
    gradient).

    A chunk's y and end state are linear in its start state S0_c:
    y_c = A_c v_c + r^_c S0_c and S_end_c = diag(d_c) S0_c + tail_c^T v_c,
    with r^ = r e^{la_prev}, d = e^{la_last}, tail = k e^{la_last - la}.
    So the backward (a) rebuilds the chunk-start states (the kernel keeps
    none) and (b) carries the state gradient back, dS_end_c = dS0_{c+1}
    and dS0_c = r^_c^T dy_c + diag(d_c) dS_end_c, each as a scan over the
    chunks in log2(n) rounds of a few ops (:func:`_affine_scan`); (c)
    differentiates every chunk's own terms at once, the chunks folded
    into the batch, the pairwise decays of A formed as the forward forms
    them (each at most 1) for groups of chunks of about
    ``BWD_PAIR_ELEMS`` elements.  A ragged T is padded to whole chunks
    with r = k = v = 0 and w = 1, which changes neither y nor the state.
    Not differentiable itself (no double backward).
    """
    BH, T, dk = r.shape
    dev = r.device
    c = chunk
    n = -(-T // c)
    pad = n * c - T

    def fold(x, fill=0.0):                  # (BH, T, d) -> (BH, n, c, d)
        x = x.float()
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad), value=fill)
        return x.reshape(BH, n, c, x.shape[-1])

    rr, kk, vv, ww = fold(r), fold(k), fold(v), fold(w, 1.0)
    gy = fold(dy) if dy is not None else torch.zeros_like(vv)
    uf = u.float()
    lw = torch.log(torch.clamp(ww, min=1e-38))
    la = torch.cumsum(lw, dim=2)
    la_prev = torch.nn.functional.pad(la[:, :, :-1], (0, 0, 1, 0))
    la_last = la[:, :, -1]                                 # (BH, n, dk)
    dec = torch.exp(la_last)
    e_prev = torch.exp(la_prev)
    rh = rr * e_prev
    e_tail = torch.exp(la_last[:, :, None] - la)
    tail = kk * e_tail

    # (a) chunk-start states: the end states are an affine scan over the
    # chunks, S_end_c = d_c S_end_{c-1} + tail_c^T v_c, from the input state
    dec4 = dec[..., None]                                  # (BH, n, dk, 1)
    kv = torch.matmul(tail.transpose(-1, -2), vv)          # (BH, n, dk, dv)
    kv[:, 0].addcmul_(dec4[:, 0], state)
    S0 = torch.cat([state[:, None], _affine_scan(dec4, kv)[:, :-1]], 1)
    # (b) start-state gradients, a scan from the last chunk back
    ry = torch.matmul(rh.transpose(-1, -2), gy)            # r^_c^T dy_c
    if dstate is not None:
        ry[:, -1].addcmul_(dec4[:, -1], dstate)
    dS0 = _affine_scan(dec4.flip(1), ry.flip(1)).flip(1)
    last = (torch.zeros_like(state) if dstate is None else dstate)[:, None]
    dSe = torch.cat([dS0[:, 1:], last], 1)                 # dS_end_c

    # (c) every chunk's own terms at once.  Log decay lw_u enters A[t, s]
    # for s < u < t, tail_s for u > s, r^_t for u < t and d for every u:
    # each gradient of lw sums those terms over exactly that range, so
    # no term is added at one end of a range and taken off at the other
    # (under strong decay that cancellation costs float32 its accuracy).
    keep = torch.ones(c, c, dtype=torch.bool, device=dev).tril()
    dA = torch.matmul(gy, vv.transpose(-1, -2)) * keep     # (BH, n, t, s)
    dAd = torch.diagonal(dA, dim1=-2, dim2=-1)             # (BH, n, c)
    A = torch.diag_embed((rr * uf[:, None, None] * kk).sum(-1))
    dr_A = torch.empty_like(rr)
    dk_A = torch.empty_like(kk)
    glw = torch.zeros_like(lw)
    below = keep.tril(-1)[..., None]                       # t > s
    apart = keep.tril(-2)[..., None]                       # t > s + 1
    group = max(1, BWD_PAIR_ELEMS // max(1, BH * c * c * dk))
    for g0 in range(0, n, group):
        g = slice(g0, g0 + group)
        D = (la_prev[:, g, :, None] - la[:, g, None]).masked_fill_(
            ~below, -torch.inf).exp_()                 # (BH, G, t, s, dk)
        Dk = D * kk[:, g, None]                        # k_s decay_ts
        A[:, g] += torch.matmul(Dk, rr[:, g, :, :, None])[..., 0]
        dr_A[:, g] = torch.matmul(dA[:, g, :, None], Dk)[..., 0, :]
        del Dk
        P = D.mul_(rr[:, g, :, None]).mul_(dA[:, g, :, :, None])
        dk_A[:, g] = P.sum(2)
        # pair (t, s)'s share of each lw_u, s < u < t: summed over s <= u - 1
        # (cumsum), then over t >= u + 1
        P = P.mul_(kk[:, g, None]).cumsum(3).mul_(apart).sum(2)
        glw[:, g, 1:] = P[:, :, :-1]
        del D, P
    drh = torch.matmul(gy, S0.transpose(-1, -2))           # (BH, n, c, dk)
    dtail = torch.matmul(vv, dSe.transpose(-1, -2))        # (BH, n, c, dk)
    gv = (torch.matmul(A.transpose(-1, -2), gy)
          + torch.matmul(tail, dSe))
    ddec = (S0 * dSe).sum(-1)                              # (BH, n, dk)
    gd = dAd[..., None] * uf[:, None, None]
    gr = dr_A + gd * kk + drh * e_prev
    gk = dk_A + gd * rr + dtail * e_tail
    gu = (dAd[..., None] * rr * kk).sum((1, 2))
    tails = torch.cumsum(dtail * tail, 2)                  # over s <= u
    glw[:, :, 1:] += tails[:, :, :-1]
    cross = torch.flip(torch.cumsum(torch.flip(drh * rh, (2,)), 2), (2,))
    glw[:, :, :-1] += cross[:, :, 1:]                      # over t >= u + 1
    glw += (ddec * dec)[:, :, None]
    gw = torch.where(ww >= 1e-38, glw / ww, 0.0)

    def unfold(x, like):                    # (BH, n, c, d) -> (BH, T, d)
        return x.reshape(BH, n * c, -1)[:, :T].to(like.dtype)

    return (unfold(gr, r), unfold(gk, k), unfold(gv, v), unfold(gw, w),
            gu.to(u.dtype), dS0[:, 0])


class WKV6BatchedFn(torch.autograd.Function):
    """Differentiable :func:`wkv6_batched` -> (y, final state): the
    forward is the kernel on CUDA tensors and the plain version on CPU
    tensors, and never writes its input state; the backward is
    :func:`wkv6_batched_backward` from the saved inputs."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, chunk: int):
        ctx.set_materialize_grads(False)
        y, new = wkv6_batched(r, k, v, w, u, state, chunk=chunk)
        ctx.save_for_backward(r, k, v, w, u, state)
        ctx.chunk = chunk
        return y, new

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, state = ctx.saved_tensors
        *grads, ds = wkv6_batched_backward(r, k, v, w, u, state, dy, dstate,
                                           chunk=ctx.chunk)
        return (*grads, ds if ctx.needs_input_grad[5] else None, None)


def wkv6_batched_train(r, k, v, w, u, state, *, chunk: int = CHUNK):
    """:func:`wkv6_batched` under autograd (:class:`WKV6BatchedFn`):
    the same shapes and results, gradients for r, k, v, w, u and the
    state; the input state is never written."""
    _check(r, k, v, w, u, state, steps=True)
    return WKV6BatchedFn.apply(r, k, v, w, u, state, chunk)


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
