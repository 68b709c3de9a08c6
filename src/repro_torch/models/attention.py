"""Attention variants of ``repro.models.attention``.

GQA/MQA     qwen2/qwen3/olmo/deepseek-coder/paligemma/whisper/hymba
  - optional QKV bias (qwen2), qk-norm (qwen3), sliding window with a
    rolling cache (hymba), cross-attention to given K/V (whisper)
MLA         deepseek-v2/v3 multi-head latent attention
  - train: expand the compressed kv and run standard causal attention
  - decode: the ABSORBED form over the compressed c_kv cache (rank
    kv_lora_rank) + the shared rope keys, never materialising per-head
    K/V for the context
  - prefill: writes that compressed cache; on the card it attends in the
    decompressed form through ``flash_attention`` (the wgmma variant at
    (D, Dv) = (192, 128)), elsewhere in the absorbed form
  - YaRN (``cfg.rope_scaling``) on both rope halves, and its m^2 on the
    softmax scale (:func:`mla_scale`)

Full-sequence paths (training, prefill) with a plain causal mask attend
through ``kernels.flash_attention_gqa`` at any length (MLA's forward too,
its rope key folded into every head: D = nope + rope, Dv = v_head_dim),
and the GQA decode path through ``kernels.flash_decode_gqa``: the CUDA
kernels on the card, their plain versions on the CPU, straight from the
model's (B, S, KV, Dh) layout.  Both compute the exact softmax attention
of the reference's dense ``_attend`` and of its chunked ``flash_attend``,
keeping the probabilities in float32 where ``_attend`` rounds them to v's
dtype.  Windowed and prefix-LM masks take the dense ``_attend`` below
``flash_threshold`` tokens and the chunked :func:`flash_attend` (torch
ops, as the reference's is jnp) at or above it; cross-attention takes the
dense ``_attend`` with an all-true mask, as in the reference.  MLA's
absorbed decode and prefill are the reference's einsums as torch ops,
with its roundings (no kernel in the reference either); MLA's prefill on
the card is the decompressed form above.

Caches are preallocated and written in place (the reference returns new
ones).  The MLA cache has no ``pos`` array: slot s is valid once
``s <= pos``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import (ParamSpec, apply_rope,
                                       apply_rope_prefix, dense,
                                       dense_specs, rms_norm, yarn_mscale)
from repro_torch.models.config import ModelConfig
from repro_torch.trips import full, trips

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
FLASH_THRESHOLD = 8192      # default; ModelConfig.flash_threshold overrides


# ------------------------------------------------------------------- masks
def causal_mask(sq: int, sk: int, *, offset: int = 0, window: int = 0,
                prefix_len: int = 0, device=None) -> torch.Tensor:
    """(sq, sk) boolean mask. offset = absolute position of query 0 minus
    key 0. window>0 = sliding window. prefix_len>0 = bidirectional
    attention within the first prefix_len keys (prefix-LM)."""
    q_pos = torch.arange(sq, device=device)[:, None] + offset
    k_pos = torch.arange(sk, device=device)[None, :]
    m = q_pos >= k_pos
    if window > 0:
        m &= (q_pos - k_pos) < window
    if prefix_len > 0:
        m |= k_pos < prefix_len
    return m


def _attend(q, k, v, mask, scale, *, scores_bf16: bool = False
            ) -> torch.Tensor:
    """q:(B,Sq,H,Dh) k,v:(B,Sk,H,Dh) mask broadcastable to (B,H,Sq,Sk).
    Scores in float32; with ``scores_bf16`` the shifted scores and the
    probabilities are held in bfloat16 (the row max stays float32)."""
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
    if scores_bf16:
        m = torch.where(mask, scores, NEG_INF).amax(dim=-1, keepdim=True)
        s16 = torch.where(mask, scores - m, NEG_INF).to(torch.bfloat16)
        p = torch.exp(s16.float()).to(torch.bfloat16)
        denom = p.float().sum(dim=-1, keepdim=True)
        probs = (p / denom.to(torch.bfloat16)).to(v.dtype)
        return torch.einsum("bhqs,bshd->bqhd", probs, v)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


def _repeat_kv(k: torch.Tensor, g: int) -> torch.Tensor:
    return torch.repeat_interleave(k, g, dim=2) if g > 1 else k


# ------------------------------------------------- chunked (flash) attention
Q_CHUNK = 1024
KV_CHUNK = 1024


def _chunk_for(S: int, target: int = Q_CHUNK) -> int:
    """Largest divisor of S that is <= target (handles e.g. hymba's 4224)."""
    c = min(target, S)
    while S % c:
        c -= 1
    return c


def flash_attend(q, k, v, scale, *, window: int = 0, prefix_len: int = 0,
                 causal: bool = True, causal_skip: bool = False,
                 q_chunk: int = Q_CHUNK, kv_chunk: int = KV_CHUNK
                 ) -> torch.Tensor:
    """Memory-efficient attention, O(S * chunk) peak: the reference's
    chunked online softmax as torch ops, chunk by chunk in its order and
    with its roundings (scores and sums float32, p rounded to v's dtype
    for p v, the output to q's dtype).

    q, k: (B, S, H, D), v: (B, Sk, H, Dv) (k/v already repeated to H
    heads); S and Sk multiples of the chunks.  ``causal_skip`` (plain
    causal, equal chunks) scans only kv chunks 0..i for q chunk i."""
    B, S, H, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    nq, nk = S // q_chunk, Sk // kv_chunk
    assert S % q_chunk == 0 and Sk % kv_chunk == 0
    dev = q.device
    skip = (causal_skip and causal and prefix_len == 0
            and q_chunk == kv_chunk)
    outs = []
    # a causal skip scans i + 1 kv chunks for q chunk i: every q chunk
    # runs then, so each one's kv trips are counted right
    for qi in (range(nq) if skip else trips(nq)):
        qb = q[:, qi * q_chunk:(qi + 1) * q_chunk].to(torch.float32)
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, H, q_chunk), float("-inf"), device=dev)
        l = torch.zeros((B, H, q_chunk), device=dev)
        acc = torch.zeros((B, H, q_chunk, Dv), device=dev)
        for ki in trips(qi + 1 if skip else nk):
            kb = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            vb = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", qb,
                             kb.to(torch.float32)) * scale
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window > 0:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            if prefix_len > 0:
                mask |= k_pos[None, :] < prefix_len
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))         # (B,H,qc)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vb.dtype), vb).to(torch.float32)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.to(q.dtype).transpose(1, 2))          # (B,qc,H,Dv)
    return torch.cat(full(outs, nq), dim=1)


# ==================================================================== GQA
def gqa_specs(cfg: ModelConfig, d_model: Optional[int] = None) -> dict:
    d = d_model or cfg.d_model
    dh, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.param_dtype
    s = {
        "q": dense_specs(d, h * dh, bias=cfg.qkv_bias, dtype=dt),
        "k": dense_specs(d, kv * dh, bias=cfg.qkv_bias, dtype=dt),
        "v": dense_specs(d, kv * dh, bias=cfg.qkv_bias, dtype=dt),
        "o": dense_specs(h * dh, d, dtype=dt),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((dh,), init="ones", dtype=dt)
        s["k_norm"] = ParamSpec((dh,), init="ones", dtype=dt)
    return s


def _gqa_qkv(p, cfg: ModelConfig, x, positions, rope: bool = True):
    B, S, _ = x.shape
    dh, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = dense(p["q"], x).reshape(B, S, h, dh)
    k = dense(p["k"], x).reshape(B, S, kv, dh)
    v = dense(p["v"], x).reshape(B, S, kv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope:                     # q and k heads rotate as one tensor
        qk = apply_rope(torch.cat([q, k], dim=2), positions, cfg.rope_theta)
        q, k = qk[:, :, :h], qk[:, :, h:]
    return q, k, v


def gqa_forward(p, cfg: ModelConfig, x, positions, *, window: int = 0,
                prefix_len: int = 0, rope: bool = True,
                kv_override: Optional[tuple] = None) -> torch.Tensor:
    """Full-sequence (train / prefill) GQA.  A plain causal mask goes
    through ``ops.flash_attention_gqa`` at any S; a window or a prefix
    through the dense ``_attend`` below ``flash_threshold`` and the
    chunked :func:`flash_attend` at or above it.  ``kv_override`` supplies
    external K/V (whisper's cross-attention), (B, Sk, KV, Dh) each,
    attended without a mask through the dense ``_attend``."""
    B, S, _ = x.shape
    dh, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    g = h // kvh
    q, k, v = _gqa_qkv(p, cfg, x, positions, rope=rope)
    scores_bf16 = getattr(cfg, "attn_scores_bf16", False)
    if kv_override is not None:
        k, v = kv_override
        mask = torch.ones((S, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = _attend(q, _repeat_kv(k, g), _repeat_kv(v, g), mask,
                      dh ** -0.5, scores_bf16=scores_bf16)
    elif window == 0 and prefix_len == 0:
        out = ops.flash_attention_gqa(q, k, v, causal=True, scale=dh ** -0.5)
    elif S >= getattr(cfg, "flash_threshold", FLASH_THRESHOLD):
        c = _chunk_for(S)
        out = flash_attend(q, _repeat_kv(k, g), _repeat_kv(v, g), dh ** -0.5,
                           window=window, prefix_len=prefix_len, q_chunk=c,
                           kv_chunk=c,
                           causal_skip=getattr(cfg, "flash_causal_skip",
                                               False))
    else:
        mask = causal_mask(S, S, window=window, prefix_len=prefix_len,
                           device=x.device)
        out = _attend(q, _repeat_kv(k, g), _repeat_kv(v, g), mask,
                      dh ** -0.5, scores_bf16=scores_bf16)
    return dense(p["o"], out.reshape(B, S, h * dh))


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   window: int = 0, *, device=None) -> dict:
    """Preallocated cache; a rolling buffer of ``window`` slots when
    window>0.  ``pos`` holds the absolute position written to each slot
    (-1: never written)."""
    L = min(window, max_len) if window > 0 else max_len
    dh, kv = cfg.head_dim, cfg.n_kv_heads
    dt = cfg.param_dtype
    return {
        "k": torch.zeros((batch, L, kv, dh), dtype=dt, device=device),
        "v": torch.zeros((batch, L, kv, dh), dtype=dt, device=device),
        "pos": torch.full((L,), -1, dtype=torch.int32, device=device),
    }


def decode_position(pos, device) -> torch.Tensor:
    """A decode step's absolute position as a 0-dim int32 tensor on
    ``device``: a tensor is taken as it is (a CUDA graph's static
    position), an int is filled in on the device (no copy from the
    host)."""
    if isinstance(pos, torch.Tensor):
        return pos
    return torch.full((), int(pos), dtype=torch.int32, device=device)


def gqa_decode(p, cfg: ModelConfig, x, cache: Optional[dict], pos, *,
               window: int = 0, rope: bool = True,
               cross_kv: Optional[tuple] = None):
    """One-token decode. x: (B,1,D); pos: absolute position, an int or a
    0-dim int tensor on x's device (:func:`decode_position`).

    Writes this token's K/V into slot ``pos`` (``pos % L`` for a rolling
    window) of ``cache`` in place, then attends through
    ``kernels.flash_decode_gqa`` with the per-slot validity mask standing
    in for the causal structure.  The position, the slot, the writes and
    the mask are computed on the device from the position tensor alone,
    so the step never waits for the host and a CUDA graph of it replays
    at whatever position the tensor holds.  With ``cross_kv`` (whisper's
    encoder K/V, (B, Sk, KV, Dh) each) it attends to those through the
    dense ``_attend``, all keys visible, and leaves ``cache`` as it is.
    Returns (out (B,1,D), cache)."""
    B = x.shape[0]
    dh, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    pos = decode_position(pos, x.device)
    positions = pos.expand(B, 1)
    q, k_new, v_new = _gqa_qkv(p, cfg, x, positions, rope=rope)
    if cross_kv is not None:
        k, v = cross_kv
        g = h // kvh
        mask = torch.ones((1, 1, 1, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = _attend(q, _repeat_kv(k, g), _repeat_kv(v, g), mask,
                      dh ** -0.5)
        return dense(p["o"], out.reshape(B, 1, h * dh)), cache
    k, v, cpos = cache["k"], cache["v"], cache["pos"]
    L = k.shape[1]
    slot = (pos % L if window > 0 else pos).reshape(1).long()
    k.index_copy_(1, slot, k_new.to(k.dtype))
    v.index_copy_(1, slot, v_new.to(v.dtype))
    cpos.index_copy_(0, slot, pos.reshape(1).to(cpos.dtype))
    valid = (cpos >= 0) & (cpos <= pos)
    if window > 0:
        valid &= cpos > pos - window
    out = ops.flash_decode_gqa(q[:, 0].contiguous(), k, v, valid,
                               scale=dh ** -0.5)
    return dense(p["o"], out.reshape(B, 1, h * dh)), cache


def gqa_prefill(p, cfg: ModelConfig, x, cache: dict, *, pos_offset: int = 0,
                window: int = 0, rope: bool = True):
    """Prompt prefill into an EMPTY cache: one full-sequence causal
    (+ sliding-window) pass that writes, in place, the K/V values the
    per-token ``gqa_decode`` loop would, with the same ``pos % L``
    rolling-slot rule.  x: (B,S,D).  Returns (attn_out (B,S,D), cache)."""
    B, S, _ = x.shape
    dh, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    g = h // kvh
    dev = x.device
    abs_pos = pos_offset + torch.arange(S, device=dev)
    positions = abs_pos[None].expand(B, S)
    q, k, v = _gqa_qkv(p, cfg, x, positions, rope=rope)
    L = cache["k"].shape[1]
    nkeep = min(S, L)                       # rolling window keeps the tail
    keep = torch.arange(pos_offset + S - nkeep, pos_offset + S, device=dev)
    slots = keep % L if window > 0 else keep
    cache["k"][:, slots] = k[:, -nkeep:].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, -nkeep:].to(cache["v"].dtype)
    cache["pos"][slots] = keep.to(torch.int32)
    if window == 0:
        out = ops.flash_attention_gqa(q, k, v, causal=True, scale=dh ** -0.5)
    else:
        mask = causal_mask(S, S, window=window, device=dev)
        out = _attend(q, _repeat_kv(k, g), _repeat_kv(v, g), mask,
                      dh ** -0.5)
    return dense(p["o"], out.reshape(B, S, h * dh)), cache


# ==================================================================== MLA
def mla_specs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    c, qc = cfg.kv_lora_rank, cfg.q_lora_rank
    dt = cfg.param_dtype
    s: dict = {
        # compressed kv path: d -> (c_kv || k_rope)
        "dkv": dense_specs(d, c + dr, dtype=dt),
        "kv_norm": ParamSpec((c,), init="ones", dtype=dt),
        "uk": ParamSpec((c, h, dn), dtype=dt),
        "uv": ParamSpec((c, h, dv), dtype=dt),
        "o": dense_specs(h * dv, d, dtype=dt),
    }
    if qc > 0:   # v3: compressed q
        s["dq"] = dense_specs(d, qc, dtype=dt)
        s["q_norm"] = ParamSpec((qc,), init="ones", dtype=dt)
        s["uq"] = ParamSpec((qc, h, dn + dr), dtype=dt)
    else:        # v2-lite: direct q
        s["q"] = ParamSpec((d, h, dn + dr), dtype=dt)
    return s


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., c) against a per-head weight w (c, H, d) -> (..., H, d):
    the reference's einsum("...c,chd->...hd") as one product."""
    c, H, d = w.shape
    return (x @ w.reshape(c, H * d)).reshape(*x.shape[:-1], H, d)


def _rope(x, cfg: ModelConfig, positions, heads: bool):
    """RoPE at ``positions``, or at 0..S-1 (a prefill's) for None."""
    if positions is None:
        return apply_rope_prefix(x, cfg.rope_theta, cfg.rope_scaling,
                                 heads=heads)
    return apply_rope(x, positions, cfg.rope_theta, cfg.rope_scaling)


def _mla_q(p, cfg: ModelConfig, x, positions):
    dn = cfg.nope_head_dim
    if cfg.q_lora_rank > 0:
        cq = rms_norm(dense(p["dq"], x), p["q_norm"])
        q = _heads(cq, p["uq"])
    else:
        q = _heads(x, p["q"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = _rope(q_rope, cfg, positions, True)
    return q_nope, q_rope      # (B,S,H,dn), (B,S,H,dr)


def _mla_ckv(p, cfg: ModelConfig, x, positions):
    c = cfg.kv_lora_rank
    ckv_kr = dense(p["dkv"], x)
    c_kv = rms_norm(ckv_kr[..., :c], p["kv_norm"])        # (B,S,c)
    k_rope = _rope(ckv_kr[..., c:], cfg, positions, False)
    return c_kv, k_rope                                    # (B,S,dr)


def mla_scale(cfg: ModelConfig) -> float:
    """The softmax scale (nope + rope)^-0.5, times m^2 under YaRN with a
    ``mscale_all_dim`` (DeepSeek-V2: m = 0.1 * 0.707 * ln 40 + 1)."""
    scale = (cfg.nope_head_dim + cfg.rope_head_dim) ** -0.5
    y = cfg.yarn
    if y and y.get("mscale_all_dim"):
        m = yarn_mscale(y["factor"], y["mscale_all_dim"])
        scale = scale * m * m
    return scale


def _mla_decompressed(p, cfg: ModelConfig, q_nope, q_rope, c_kv, k_rope):
    """Causal attention with the compressed kv expanded per head and the
    shared rope key folded into every head (q = [q_nope; q_rope],
    k = [k_nope; k_rope]) through ``ops.flash_attention_gqa`` at
    D = nope + rope, Dv = v -> (B, S, H * dv)."""
    B, S, h, _ = q_nope.shape
    dr = cfg.rope_head_dim
    k_nope = _heads(c_kv, p["uk"])
    v = _heads(c_kv, p["uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, h, dr)],
                  dim=-1)
    out = ops.flash_attention_gqa(q, k, v.contiguous(), causal=True,
                                  scale=mla_scale(cfg))
    return out.reshape(B, S, h * cfg.v_head_dim)


def mla_forward(p, cfg: ModelConfig, x, positions) -> torch.Tensor:
    """Full-sequence MLA in the decompressed form
    (:func:`_mla_decompressed`): the function of the reference's two-part
    einsum below ``flash_threshold`` and of its ``flash_attend`` above
    it."""
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_ckv(p, cfg, x, positions)
    return dense(p["o"], _mla_decompressed(p, cfg, q_nope, q_rope, c_kv,
                                           k_rope))


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                   device=None) -> dict:
    dt = cfg.param_dtype
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dt,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.rope_head_dim), dtype=dt,
                              device=device),
    }


def _mla_absorbed(p, cfg: ModelConfig, q_nope, q_rope, ck, kr, mask):
    """Attention over the compressed cache in the absorbed form.
    q_nope (B,Sq,H,dn), q_rope (B,Sq,H,dr), ck (B,L,c), kr (B,L,dr), mask
    broadcastable to (B,H,Sq,L) -> (B,Sq,H*dv).  q_c and ctx_c come out
    in the parameters' / the cache's dtype, scores are float32 and the
    probabilities are rounded to the cache's dtype, as in the reference."""
    B, Sq, h, _ = q_nope.shape
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
    uk, uv = p["uk"], p["uv"]
    # absorb W_uk into the query: q_c = q_nope @ W_uk^T -> (B,Sq,H,c)
    q_c = torch.einsum("bqhd,chd->bqhc", q_nope, uk)
    f32 = torch.float32
    scores = (torch.einsum("bqhc,bsc->bhqs", q_c.to(f32), ck.to(f32))
              + torch.einsum("bqhd,bsd->bhqs", q_rope.to(f32), kr.to(f32))
              ) * mla_scale(cfg)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(ck.dtype)
    ctx_c = torch.einsum("bhqs,bsc->bqhc", probs, ck)      # (B,Sq,H,c)
    out = torch.einsum("bqhc,chd->bqhd", ctx_c, uv)        # absorb W_uv
    return out.reshape(B, Sq, h * cfg.v_head_dim)


def mla_decode(p, cfg: ModelConfig, x, cache: dict, pos: int):
    """One-token decode in the ABSORBED form over the compressed cache,
    written in place at ``pos``.  Returns (out (B,1,D), cache)."""
    B = x.shape[0]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)         # (B,1,H,*)
    c_new, kr_new = _mla_ckv(p, cfg, x, positions)        # (B,1,c),(B,1,dr)
    ck, kr = cache["c_kv"], cache["k_rope"]
    ck[:, pos] = c_new[:, 0].to(ck.dtype)
    kr[:, pos] = kr_new[:, 0].to(kr.dtype)
    valid = torch.arange(ck.shape[1], device=x.device) <= pos
    out = _mla_absorbed(p, cfg, q_nope, q_rope, ck, kr, valid)
    return dense(p["o"], out), cache


def mla_prefill(p, cfg: ModelConfig, x, cache: dict):
    """Prompt prefill into the compressed decode cache, writing positions
    0..S-1 in place.  Two forms of the same attention, chosen by the
    device: on the card the prompt's c_kv is expanded per head and
    attends through ``flash_attention`` (:func:`_mla_decompressed`);
    elsewhere the vectorised twin of :func:`mla_decode`, the absorbed
    einsums over the cache as stored (:func:`_mla_absorbed`).  x:
    (B,S,D).  Returns (out (B,S,D), cache)."""
    S = x.shape[1]
    dev = x.device
    q_nope, q_rope = _mla_q(p, cfg, x, None)              # (B,S,H,*)
    c_new, kr_new = _mla_ckv(p, cfg, x, None)             # (B,S,c),(B,S,dr)
    cache["c_kv"][:, :S] = c_new.to(cache["c_kv"].dtype)
    cache["k_rope"][:, :S] = kr_new.to(cache["k_rope"].dtype)
    ck, kr = cache["c_kv"][:, :S], cache["k_rope"][:, :S]
    if dev.type == "cuda":
        out = _mla_decompressed(p, cfg, q_nope, q_rope, ck, kr)
    else:
        out = _mla_absorbed(p, cfg, q_nope, q_rope, ck, kr,
                            causal_mask(S, S, device=dev))
    return dense(p["o"], out), cache
