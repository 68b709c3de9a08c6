"""Dropless Mixture-of-Experts: softmax top-k routing and a grouped expert
product that reads only the experts some token was routed to.  CUDA
kernels on the card (``csrc/moe.cu``), their plain PyTorch versions on
the CPU.

The JAX package has no kernel here: its MoE layer is GShard's capacity
dispatch as einsums (``repro.models.moe``), which the port keeps as the
default path (``models/moe.py``).  These kernels serve the published
DeepSeek-V2 routing (``ModelConfig.moe_dropless``), where every token
goes to its top-k experts and each routed row is weighted by its own
gate.  What bounds them: at prefill sizes the bytes of the routed
experts' weights (26 layers x 64 experts x 3 x 2048 x 1408 x 2 B =
28.8 GB a 1,024-token prompt of DeepSeek-V2-Lite, against 4.6 TFLOP of
the whole forward); at a decode step the bytes of the k experts a token
picked.  So the design streams each routed expert's weights once a tile
of up to ``BM`` = 128 of its rows, and never touches an expert no token
picked.

Three launches a layer, none waiting for the host (``csrc/moe.cu`` says
how each works):

  * ``moe_route`` (site ``moe_route``, one CTA): softmax of the router's
    float32 logits, greedy top-k (the larger probability first, the
    lower expert on a tie), the gates (renormalised to sum to 1 only
    with ``norm_topk``, then times ``scale``), each routed row's rank
    within its expert in token-major order, the experts' row counts and
    their offsets, the tile map (tile -> expert, first and last sorted
    row) over an upper bound of ceil(T k / BM) + E tiles, and the sorted
    order of the routed rows; it adds the counts to an int64 counter of
    routed rows per (layer, expert), read only after a run;
  * ``moe_gemm`` gate-up (site ``moe_gemm``): for each tile and block of
    columns (64 small_m, 128 tile), silu(x W_gate) * (x W_up) over the
    tile's rows, gathered from the tokens, into the sorted hidden rows
    (bfloat16), with wgmma and the weights through TMA;
  * ``moe_gemm`` down: for each tile and block of columns (128 small_m,
    256 tile), the hidden rows times W_down, each row times its gate,
    written to its own (token, k) slot (float32).

Then ``out = slots.view(T, k, D).sum(1)``.  Each output row depends on
its own input row alone, so the values do not depend on the order of the
rows within a tile.  Two variants of the grouped product (``dispatch``
counts launches by variant): ``small_m`` (BM = 64, one warpgroup) while a
call routes at most ``SMALL_M_TOKENS`` tokens (a decode step: no expert
gets more than one tile), ``tile`` (BM = 128, two warpgroups) above it.
The kernels take bfloat16 activations and weights, widths that are
multiples of 8, at most 64 experts and 8 of them a token.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, dispatch

SITE_GEMM = "moe_gemm"
SITE_ROUTE = "moe_route"
#: the device counter of routed rows per (layer, expert)
ROWS_COUNTER = "moe_expert_rows"
#: rows a tile of the grouped product holds, by variant (64 a warpgroup)
BM = {"small_m": 64, "tile": 128}
#: the most tokens a call routes with the small_m variant
SMALL_M_TOKENS = BM["small_m"]
#: the routing kernel's limits (``csrc/moe.cu``)
MAX_EXPERTS, MAX_TOP_K = 64, 8
#: elements a segment of the scratch buffers is rounded up to (16 bytes
#: of int32 or float32)
ALIGN = 4

_ROUTE_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
_GEMM_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                  + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def variant(n_tokens: int) -> str:
    """The grid variant of a call that routes ``n_tokens`` tokens."""
    return "small_m" if n_tokens <= SMALL_M_TOKENS else "tile"


def n_tiles_bound(n_tokens: int, top_k: int, n_experts: int, bm: int) -> int:
    """Tiles of the grid: ceil(T k / BM) + E, at least the tiles any
    routing needs (each expert's last tile may be partial)."""
    return -(-n_tokens * top_k // bm) + n_experts


# ------------------------------------------------------------ plain versions
def route_plain(logits: torch.Tensor, top_k: int, norm_topk: bool,
                scale: float):
    """logits (T, E) float32 -> (idx (T, k) int64, gates (T, k) float32):
    softmax, the k largest probabilities (largest first, the lower expert
    on a tie: a stable descending sort), renormalised with ``norm_topk``,
    times ``scale``."""
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :top_k], idx[:, :top_k]
    if norm_topk:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return idx, gates * scale


def schedule_plain(idx: torch.Tensor, n_experts: int, bm: int) -> dict:
    """The routing kernel's bookkeeping from idx (T, k): ``counts`` (E,),
    ``offsets`` (E,) (exclusive sum), ``slot`` (T k,) the flat (t, k)
    index of each sorted row (experts in order, token-major within one),
    ``tiles`` (bound, 3) int32 of (expert or -1, first row, end row)."""
    T, K = idx.shape
    flat = idx.reshape(-1).long()
    counts = torch.zeros(n_experts, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    offsets = torch.cumsum(counts, 0) - counts
    slot = torch.sort(flat, stable=True).indices
    n_tiles = n_tiles_bound(T, K, n_experts, bm)
    tiles = torch.full((n_tiles, 3), -1, dtype=torch.int32)
    tiles[:, 1:] = 0
    t = 0
    for e in range(n_experts):
        c, off = int(counts[e]), int(offsets[e])
        for r0 in range(0, c, bm):
            tiles[t] = torch.tensor([e, off + r0, off + min(r0 + bm, c)])
            t += 1
    # past the used tiles the kernel writes -1 and the would-be rows of
    # an expert index E: only the expert column is read there
    return dict(counts=counts, offsets=offsets, slot=slot, tiles=tiles,
                n_used=t)


def experts_plain(x: torch.Tensor, idx: torch.Tensor, gates: torch.Tensor,
                  w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor) -> torch.Tensor:
    """The grouped product's arithmetic, expert by expert: x (T, D), idx
    and gates (T, k), weights (E, D, F), (E, D, F), (E, F, D) -> (T, D)
    float32.  Products accumulate in float32; the hidden silu(g) * u is
    rounded to x's dtype (as the kernel stores it); each (t, k) row times
    its gate, then the k rows of a token summed in float32."""
    T, D = x.shape
    K = idx.shape[1]
    flat = idx.reshape(-1)
    g_flat = gates.reshape(-1).float()
    y = torch.zeros((T * K, D), dtype=torch.float32, device=x.device)
    for e in range(w_gate.shape[0]):
        sel = (flat == e).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        xe = x[sel // K].float()
        h = F.silu(xe @ w_gate[e].float()) * (xe @ w_up[e].float())
        h = h.to(x.dtype).float()
        y[sel] = (h @ w_down[e].float()) * g_flat[sel, None]
    return y.view(T, K, D).sum(dim=1)


# -------------------------------------------------------------- the kernels
def _segments(sizes: list, dtype, device) -> list:
    """Views of one buffer, each segment starting on ALIGN elements."""
    starts, n = [], 0
    for s in sizes:
        starts.append(n)
        n += -(-s // ALIGN) * ALIGN
    buf = torch.empty(n, dtype=dtype, device=device)
    return [buf[a:a + s] for a, s in zip(starts, sizes)]


def _check(x, logits, w_gate, w_up, w_down, counter, top_k) -> None:
    T, D = x.shape
    E, D2, Fh = w_gate.shape
    if (D2 != D or w_up.shape != w_gate.shape
            or tuple(w_down.shape) != (E, Fh, D)
            or tuple(logits.shape) != (T, E)):
        raise ValueError(f"moe: shapes x {tuple(x.shape)}, logits "
                         f"{tuple(logits.shape)}, weights "
                         f"{tuple(w_gate.shape)} / {tuple(w_down.shape)}")
    if E > MAX_EXPERTS or not 1 <= top_k <= min(E, MAX_TOP_K):
        raise ValueError(f"moe: the routing kernel takes up to "
                         f"{MAX_EXPERTS} experts and up to {MAX_TOP_K} a "
                         f"token, got {E} and {top_k}")
    if D % 8 or Fh % 8:
        raise ValueError(f"moe: widths a multiple of 8, got {D} and {Fh}")
    for t in (x, logits, w_gate, w_up, w_down, counter):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("moe: every tensor contiguous on x's device")
    for t in (x, w_gate, w_up, w_down):
        if t.dtype != torch.bfloat16 or t.data_ptr() % 16:
            raise ValueError("moe: bfloat16 activations and weights, "
                             "16-byte aligned")
    if logits.dtype != torch.float32 or counter.dtype != torch.int64:
        raise ValueError("moe: float32 logits and an int64 counter")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w_gate, w_up, w_down)):
        raise NotImplementedError("moe: the grouped expert kernels have no "
                                  "backward")


def _routed_cuda(x, logits, w_gate, w_up, w_down, top_k, norm_topk, scale,
                 counter):
    _check(x, logits, w_gate, w_up, w_down, counter, top_k)
    T, D = x.shape
    E, _, Fh = w_gate.shape
    var = variant(T)
    bm = BM[var]
    n_tiles = n_tiles_bound(T, top_k, E, bm)
    n = T * top_k
    dev = x.device
    idx, rank, offs, slot, tiles = _segments(
        [n, n, E, n, 3 * n_tiles], torch.int32, dev)
    gate, sgate = _segments([n, n], torch.float32, dev)
    h = torch.empty((n, Fh), dtype=x.dtype, device=dev)
    y = torch.empty((n, D), dtype=torch.float32, device=dev)
    wg = bm // 64
    _build.launch("moe_route_launch", _ROUTE_ARGTYPES, SITE_ROUTE, dev,
                  logits.data_ptr(), idx.data_ptr(), rank.data_ptr(),
                  gate.data_ptr(), offs.data_ptr(), slot.data_ptr(),
                  sgate.data_ptr(), tiles.data_ptr(), counter.data_ptr(), T,
                  E, top_k, bm, n_tiles, int(bool(norm_topk)), float(scale))
    _build.launch("moe_gemm_launch", _GEMM_ARGTYPES, SITE_GEMM, dev, 0,
                  x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                  h.data_ptr(), slot.data_ptr(), sgate.data_ptr(),
                  tiles.data_ptr(), n_tiles, E, D, Fh, top_k, wg,
                  variant=var)
    _build.launch("moe_gemm_launch", _GEMM_ARGTYPES, SITE_GEMM, dev, 1,
                  h.data_ptr(), w_down.data_ptr(), None, y.data_ptr(),
                  slot.data_ptr(), sgate.data_ptr(), tiles.data_ptr(),
                  n_tiles, E, Fh, D, top_k, wg, variant=var)
    out = y.view(T, top_k, D).sum(dim=1)
    return out, idx.view(T, top_k), gate.view(T, top_k)


def routed_experts(x: torch.Tensor, logits: torch.Tensor,
                   w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor, *, top_k: int, norm_topk: bool,
                   scale: float, counter: torch.Tensor):
    """The routed experts of a dropless MoE layer: x (T, D) in the
    weights' dtype, the router's logits (T, E) float32, weights (E, D, F),
    (E, D, F), (E, F, D) -> (out (T, D) float32, idx (T, k), gates (T, k)
    float32).  ``counter`` (E,) int64 gains each expert's routed rows.

    CPU tensors take the plain versions; CUDA tensors launch the three
    kernels on the current stream (no host synchronisation) or raise.
    The routing kernel adds to ``counter`` with atomics, so replica
    threads may share it."""
    if dispatch.plain(x.device, SITE_ROUTE, SITE_GEMM):
        idx, gates = route_plain(logits, top_k, norm_topk, scale)
        counter.scatter_add_(0, idx.reshape(-1),
                             torch.ones(idx.numel(), dtype=counter.dtype))
        out = experts_plain(x, idx, gates, w_gate, w_up, w_down)
        return out, idx, gates
    return _routed_cuda(x, logits, w_gate, w_up, w_down, top_k, norm_topk,
                        scale, counter)
