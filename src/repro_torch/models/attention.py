"""Attention for the dense family: grouped-query attention (GQA/MQA).

The GQA half of ``repro.models.attention``: optional QKV bias (qwen2),
qk-norm (qwen3), sliding window with a rolling cache (hymba's layers).
Full-sequence paths take a causal mask and an optional window; the
decode path takes a cache and the current position, and attends through
``kernels.flash_decode_gqa`` — the CUDA kernel on the card, its plain
version on the CPU — straight from the cache's (B, L, KV, Dh) layout.

Caches are preallocated and written in place (the reference returns new
ones).  The chunked ``flash_attend``, cross-attention (whisper's
``kv_override`` / ``cross_kv``) and the MLA functions are not ported yet:
ROADMAP.md queue A, item A6.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import (ParamSpec, apply_rope, dense,
                                       dense_specs, rms_norm)
from repro_torch.models.config import ModelConfig

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


def flash_attend(*args, **kwargs):
    raise NotImplementedError(
        "chunked flash attention (repro.models.attention.flash_attend) is "
        "not ported to repro_torch yet: ROADMAP.md queue A, item A6")


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
                prefix_len: int = 0, rope: bool = True) -> torch.Tensor:
    """Full-sequence (train / prefill) GQA."""
    B, S, _ = x.shape
    dh, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    g = h // kvh
    if S >= getattr(cfg, "flash_threshold", FLASH_THRESHOLD):
        flash_attend()
    q, k, v = _gqa_qkv(p, cfg, x, positions, rope=rope)
    mask = causal_mask(S, S, window=window, prefix_len=prefix_len,
                       device=x.device)
    out = _attend(q, _repeat_kv(k, g), _repeat_kv(v, g), mask, dh ** -0.5,
                  scores_bf16=getattr(cfg, "attn_scores_bf16", False))
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


def gqa_decode(p, cfg: ModelConfig, x, cache: dict, pos: int, *,
               window: int = 0, rope: bool = True):
    """One-token decode. x: (B,1,D); pos: absolute position (an int).

    Writes this token's K/V into slot ``pos`` (``pos % L`` for a rolling
    window) of ``cache`` in place, then attends through
    ``kernels.flash_decode_gqa`` with the per-slot validity mask standing
    in for the causal structure.  Returns (out (B,1,D), cache)."""
    B = x.shape[0]
    dh, h = cfg.head_dim, cfg.n_heads
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _gqa_qkv(p, cfg, x, positions, rope=rope)
    k, v, cpos = cache["k"], cache["v"], cache["pos"]
    L = k.shape[1]
    slot = pos % L if window > 0 else pos
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    cpos[slot] = pos
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
    mask = causal_mask(S, S, window=window, device=dev)
    out = _attend(q, _repeat_kv(k, g), _repeat_kv(v, g), mask, dh ** -0.5)
    return dense(p["o"], out.reshape(B, S, h * dh)), cache
