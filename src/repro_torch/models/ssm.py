"""Selective SSM (Mamba-style) head + the Hymba hybrid architecture.

Port of ``repro.models.ssm``.  hymba-1.5b (arXiv:2411.13676): each layer
runs ATTENTION HEADS and MAMBA HEADS **in parallel** on the same input;
branch outputs are RMS-normalised, scaled by learned per-channel betas,
averaged, and projected.  Learnable meta tokens are prepended to the
sequence; all layers use sliding-window attention except the global
layers (first / middle / last).  The reference's simplifications hold:
no cross-layer KV sharing, a standard Mamba-1 selective scan (conv4 +
silu + data-dependent dt/B/C).

The selective scan is the reference's ``lax.scan`` as a float32 loop of
torch ops over time (the reference has no Pallas kernel for it): the
decays exp(dt A) and inputs dt x B of every step are formed at once,
and the loop carries only h_t = dA_t h_{t-1} + dBx_t.  Attention goes
through the GQA functions of ``models.attention``: the global layers'
full-sequence passes through the flash_attention kernel, every layer's
decode through flash_decode.  Layers are unrolled: the global layers
carry full-length KV caches, the windowed layers rolling caches of
``sliding_window`` slots, each over ``max_len + n_meta_tokens``
positions, beside an fp32 SSM state and a conv tail per layer.  Under
grad every layer is rematerialised under ``nothing_saveable``, as the
reference's forward does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models.common import (ParamSpec, ParamTree, dense,
                                       dense_specs, init_params, remat,
                                       rms_norm, softmax_xent)
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import ffn_apply, ffn_specs
from repro_torch.trips import full, trips


# ----------------------------------------------------------- mamba head
def mamba_specs(cfg: ModelConfig, d_inner: int) -> dict:
    d = cfg.d_model
    n = cfg.ssm_state
    dt_rank = max(1, math.ceil(d / 16))
    dtp = cfg.param_dtype
    return {
        "in_x": dense_specs(d, d_inner, dtype=dtp),
        "in_z": dense_specs(d, d_inner, dtype=dtp),
        "conv": ParamSpec((cfg.ssm_conv, d_inner), dtype=dtp),
        "conv_b": ParamSpec((d_inner,), init="zeros", dtype=dtp),
        "dt_a": dense_specs(d_inner, dt_rank, dtype=dtp),
        "dt_b": dense_specs(dt_rank, d_inner, bias=True, dtype=dtp),
        "bc": dense_specs(d_inner, 2 * n, dtype=dtp),
        "a_log": ParamSpec((d_inner, n), init="zeros", dtype=torch.float32),
        "d_skip": ParamSpec((d_inner,), init="ones", dtype=torch.float32),
        "out": dense_specs(d_inner, d, dtype=dtp),
    }


def _causal_conv(x, kernel, bias, tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv over seq.  x: (B,S,Di); kernel: (K,Di);
    tail: (B,K-1,Di) previous inputs for decode streaming.  Returns
    (out (B,S,Di), the new tail)."""
    K = kernel.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)          # (B, S+K-1, Di)
    out = sum(xp[:, i:i + x.shape[1], :] * kernel[i] for i in range(K))
    return out + bias, xp[:, -(K - 1):, :]


def selective_scan(dt, Bm, Cm, xx, A, h):
    """The recurrence h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,
    y_t = h_t C_t, in float32.  dt, xx: (B,S,Di); Bm, Cm: (B,S,N);
    A: (Di,N); h: (B,Di,N).  Returns (y (B,S,Di), final h)."""
    dA = torch.exp(dt[..., None] * A)                      # (B,S,Di,N)
    dBx = (dt * xx)[..., None] * Bm[:, :, None, :]         # (B,S,Di,N)
    # views of each step, taken once: the backward of one unbind stacks
    # the S step gradients, where S reads dA[:, t] would each write a
    # zero gradient of all of dA (O(S^2) bytes)
    dAs, dBxs = dA.unbind(1), dBx.unbind(1)
    hs = []
    for t in trips(dt.shape[1]):
        h = dAs[t] * h + dBxs[t]
        hs.append(h)
    hs = torch.stack(full(hs, dt.shape[1]), dim=1)         # (B,S,Di,N)
    y = (hs * Cm[:, :, None, :]).sum(dim=-1)
    return y, h


def mamba_apply(p, cfg: ModelConfig, x, ssm_state, conv_tail):
    """x: (B,S,D); ssm_state: (B,Di,N) fp32; conv_tail: (B,K-1,Di) or
    None (zeros).  Returns (out (B,S,D), ssm_state, conv_tail), the
    states new tensors."""
    n = cfg.ssm_state
    xx = dense(p["in_x"], x)
    z = dense(p["in_z"], x)
    xx, conv_tail = _causal_conv(xx, p["conv"], p["conv_b"], conv_tail)
    xx = F.silu(xx)                                        # (B,S,Di)
    dt = F.softplus(dense(p["dt_b"], dense(p["dt_a"], xx))
                    ).to(torch.float32)                    # (B,S,Di)
    bc = dense(p["bc"], xx).to(torch.float32)
    Bm, Cm = bc[..., :n], bc[..., n:]                      # (B,S,N)
    A = -torch.exp(p["a_log"])                             # (Di,N) negative
    xf = xx.to(torch.float32)
    y, ssm_state = selective_scan(dt, Bm, Cm, xf, A, ssm_state)
    y = y + xf * p["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    return dense(p["out"], y), ssm_state, conv_tail


# ------------------------------------------------------------- hymba
class HymbaModel:
    """Hybrid attention+SSM heads, meta tokens, SWA + global layers."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.d_inner = int(cfg.ssm_expand * cfg.d_model)
        g = cfg.global_layers or (0, cfg.n_layers // 2, cfg.n_layers - 1)
        self.global_layers = set(g)

    def _layer_specs(self) -> dict:
        cfg = self.cfg
        dtp = cfg.param_dtype
        return {
            "norm": ParamSpec((cfg.d_model,), init="ones", dtype=dtp),
            "attn": attn.gqa_specs(cfg),
            "mamba": mamba_specs(cfg, self.d_inner),
            "beta_attn": ParamSpec((cfg.d_model,), init="ones", dtype=dtp),
            "beta_ssm": ParamSpec((cfg.d_model,), init="ones", dtype=dtp),
            "norm_ffn": ParamSpec((cfg.d_model,), init="ones", dtype=dtp),
            "ffn": ffn_specs(cfg.d_model, cfg.d_ff, cfg.act, dtp),
        }

    def param_specs(self) -> dict:
        cfg = self.cfg
        dtp = cfg.param_dtype
        s = {
            "embed": ParamSpec((cfg.vocab_size, cfg.d_model), init="embed",
                               dtype=dtp),
            "meta": ParamSpec((cfg.n_meta_tokens, cfg.d_model), init="embed",
                              dtype=dtp),
            "final_norm": ParamSpec((cfg.d_model,), init="ones", dtype=dtp),
            "head": ParamSpec((cfg.d_model, cfg.vocab_size), dtype=dtp),
        }
        for i in range(cfg.n_layers):
            s[f"layer_{i}"] = self._layer_specs()
        return s

    def init(self, seed: int = 0, *, device=None) -> ParamTree:
        """Random weights from a ``torch.Generator`` seeded with ``seed``,
        drawn on ``device`` (None: the card; raises without one)."""
        return init_params(self.param_specs(), seed=seed,
                           device=resolve(device))

    def _window(self, i: int) -> int:
        return 0 if i in self.global_layers else self.cfg.sliding_window

    def _fuse(self, p, x, a_out, m_out) -> torch.Tensor:
        """x + the averaged, normalised branches, then the FFN."""
        cfg = self.cfg
        fused = 0.5 * (rms_norm(a_out, None) * p["beta_attn"]
                       + rms_norm(m_out, None) * p["beta_ssm"])
        x = x + fused.to(x.dtype)
        return x + ffn_apply(p["ffn"], rms_norm(x, p["norm_ffn"]), cfg.act)

    def _block(self, p, x: torch.Tensor, positions: torch.Tensor,
               i: int) -> torch.Tensor:
        """Layer i of the full-sequence forward (zero SSM state)."""
        cfg = self.cfg
        xn = rms_norm(x, p["norm"])
        a_out = attn.gqa_forward(p["attn"], cfg, xn, positions,
                                 window=self._window(i))
        ssm0 = x.new_zeros((x.shape[0], self.d_inner, cfg.ssm_state),
                           dtype=torch.float32)
        m_out = mamba_apply(p["mamba"], cfg, xn, ssm0, None)[0]
        return self._fuse(p, x, a_out, m_out)

    def forward(self, params, tokens: torch.Tensor, *,
                last_only: bool = False) -> torch.Tensor:
        """tokens (B,S) -> logits (B,S,V) of the text positions (the meta
        prefix runs first and is dropped).  Under grad each layer is
        rematerialised under ``nothing_saveable``."""
        cfg = self.cfg
        B, S = tokens.shape
        M = cfg.n_meta_tokens
        x = F.embedding(tokens, params["embed"])
        meta = params["meta"][None].expand(B, M, cfg.d_model).to(x.dtype)
        x = torch.cat([meta, x], dim=1)
        positions = torch.arange(S + M, device=x.device)[None].expand(
            B, S + M)
        block = remat(self._block, "nothing_saveable")
        for i in range(cfg.n_layers):
            x = block(params[f"layer_{i}"], x, positions, i)
        x = rms_norm(x, params["final_norm"])
        x = x[:, M:, :]
        if last_only:
            x = x[:, -1:, :]
        return x @ params["head"]

    def loss(self, params, batch: dict):
        """batch: tokens, labels and an optional mask -> (loss, {})."""
        logits = self.forward(params, batch["tokens"])
        return softmax_xent(logits, batch["labels"], batch.get("mask")), {}

    # --------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int, *, device=None) -> dict:
        """Per layer: a GQA cache over ``max_len + n_meta_tokens``
        positions (rolling, ``sliding_window`` slots, on windowed
        layers), the fp32 SSM state and the conv tail."""
        cfg = self.cfg
        dev = resolve(device)
        K = cfg.ssm_conv
        return {f"layer_{i}": {
            "attn": attn.gqa_init_cache(cfg, batch,
                                        max_len + cfg.n_meta_tokens,
                                        window=self._window(i), device=dev),
            "ssm": torch.zeros((batch, self.d_inner, cfg.ssm_state),
                               dtype=torch.float32, device=dev),
            "conv": torch.zeros((batch, K - 1, self.d_inner),
                                dtype=cfg.param_dtype, device=dev),
        } for i in range(cfg.n_layers)}

    def _layer_step(self, p, c: dict, x: torch.Tensor, i: int, *,
                    pos: Optional[int] = None) -> torch.Tensor:
        """Layer i on the decode branch, its cache ``c`` written in
        place: one token at absolute position ``pos``, or (pos None) a
        prompt prefill from an empty cache at the meta-offset
        positions."""
        cfg = self.cfg
        xn = rms_norm(x, p["norm"])
        if pos is None:
            a_out, _ = attn.gqa_prefill(p["attn"], cfg, xn, c["attn"],
                                        pos_offset=cfg.n_meta_tokens,
                                        window=self._window(i))
        else:
            a_out, _ = attn.gqa_decode(p["attn"], cfg, xn, c["attn"], pos,
                                       window=self._window(i))
        m_out, ssm, conv = mamba_apply(p["mamba"], cfg, xn, c["ssm"],
                                       c["conv"])
        c["ssm"].copy_(ssm)
        c["conv"].copy_(conv)
        return self._fuse(p, x, a_out, m_out)

    def _decode_embed(self, params, cache: dict, x: torch.Tensor,
                      pos_abs: int) -> torch.Tensor:
        """One decode step from an already-embedded (B,1,D) input."""
        for i in range(self.cfg.n_layers):
            x = self._layer_step(params[f"layer_{i}"], cache[f"layer_{i}"],
                                 x, i, pos=pos_abs)
        return x

    def prefill_meta(self, params, cache: dict, batch: int) -> dict:
        """Feed the learnable meta tokens through the decode path so the
        caches/SSM states match the forward pass's meta prefix."""
        cfg = self.cfg
        for i in range(cfg.n_meta_tokens):
            x = params["meta"][i][None, None].expand(
                batch, 1, cfg.d_model).to(cfg.param_dtype)
            self._decode_embed(params, cache, x, i)
        return cache

    def prefill(self, params, cache: dict, tokens: torch.Tensor):
        """Prompt prefill from an EMPTY decode cache: the decode branch of
        every layer run full-sequence — gqa_prefill writes each layer's
        (global or rolling-window) KV cache at the meta-offset positions,
        and mamba_apply runs the same selective-scan recurrence from the
        zero state the decode loop starts from.  Meta tokens are NOT fed
        (positions are offset past them instead), matching the greedy
        serve decode loop, which never meta-prefills.  tokens: (B,S) ->
        (last-position logits (B,1,V), cache)."""
        x = F.embedding(tokens, params["embed"])
        for i in range(self.cfg.n_layers):
            x = self._layer_step(params[f"layer_{i}"], cache[f"layer_{i}"],
                                 x, i)
        x = rms_norm(x[:, -1:, :], params["final_norm"])
        return x @ params["head"], cache

    def decode_step(self, params, cache: dict, tokens: torch.Tensor,
                    pos: int):
        """tokens (B,1); pos = TEXT position (meta offset added here).
        The cache must have been meta-prefilled (prefill_meta) or filled
        by a prompt prefill for logits to match the forward pass."""
        x = F.embedding(tokens, params["embed"])
        x = self._decode_embed(params, cache, x,
                               int(pos) + self.cfg.n_meta_tokens)
        x = rms_norm(x, params["final_norm"])
        return x @ params["head"], cache
