"""Whisper-tiny style encoder-decoder backbone (arXiv:2212.04356).

Port of ``repro.models.whisper``.  The conv/mel frontend is a STUB:
callers supply precomputed frame embeddings (B, encoder_seq, d_model) —
what the two conv layers would output.  This module is the transformer
backbone:

encoder: sinusoidal positions + pre-LN blocks (bidirectional
         self-attention, GELU MLP), final LN.
decoder: learned positions + pre-LN blocks (causal self-attention through
         the flash kernels, cross-attention to the encoder through the
         dense ``_attend``, GELU MLP); logits tied to the token embedding.

Decode caches: per-layer self-attention K/V (preallocated, written in
place) plus the cross-attention K/V of every layer, computed once from
the encoder output by :meth:`WhisperModel.prefill_cross` (zeros until
then, as the serve path leaves them).  There is no prompt ``prefill``:
``FusedGenerator`` walks a prompt through ``decode_step``.  Under grad
every encoder and decoder layer is rematerialised under
``nothing_saveable``, as the reference's scans are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models.common import (ParamSpec, ParamTree, dense,
                                       init_params, layer_norm, remat,
                                       softmax_xent)
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import ffn_apply, ffn_specs


def _ln_specs(d: int, dtp) -> dict:
    return {"scale": ParamSpec((d,), init="ones", dtype=dtp),
            "bias": ParamSpec((d,), init="zeros", dtype=dtp)}


def _ln(p, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, p["scale"], p["bias"])


def sinusoids(length: int, channels: int, *, device=None) -> torch.Tensor:
    """(length, channels) float32 sinusoidal positions: sin | cos."""
    f32 = torch.float32
    t = torch.arange(length, dtype=f32, device=device)[:, None]
    step = torch.log(torch.tensor(10000.0, dtype=f32, device=device)) / (
        channels // 2 - 1)
    inv = torch.exp(-torch.arange(channels // 2, dtype=f32, device=device)
                    * step)
    ang = t * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class WhisperModel:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def _enc_layer(self) -> dict:
        cfg = self.cfg
        dtp = cfg.param_dtype
        return {"ln1": _ln_specs(cfg.d_model, dtp),
                "attn": attn.gqa_specs(cfg),
                "ln2": _ln_specs(cfg.d_model, dtp),
                "ffn": ffn_specs(cfg.d_model, cfg.d_ff, "gelu_mlp", dtp)}

    def _dec_layer(self) -> dict:
        cfg = self.cfg
        s = self._enc_layer()
        s["ln_x"] = _ln_specs(cfg.d_model, cfg.param_dtype)
        s["xattn"] = attn.gqa_specs(cfg)
        return s

    def param_specs(self) -> dict:
        cfg = self.cfg
        dtp = cfg.param_dtype
        return {
            "embed": ParamSpec((cfg.vocab_size, cfg.d_model), init="embed",
                               dtype=dtp),
            "pos_dec": ParamSpec((cfg.max_seq_len, cfg.d_model),
                                 init="embed", dtype=dtp),
            "enc_layers": [self._enc_layer()
                           for _ in range(cfg.encoder_layers)],
            "ln_enc": _ln_specs(cfg.d_model, dtp),
            "dec_layers": [self._dec_layer() for _ in range(cfg.n_layers)],
            "ln_dec": _ln_specs(cfg.d_model, dtp),
        }

    def init(self, seed: int = 0, *, device=None) -> ParamTree:
        """Random weights from a ``torch.Generator`` seeded with ``seed``,
        drawn on ``device`` (None: the card; raises without one)."""
        return init_params(self.param_specs(), seed=seed,
                           device=resolve(device))

    # ---------------------------------------------------------- encoder
    def _enc_block(self, lp, h: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        # bidirectional self-attention: prefix_len = Sf makes every key
        # visible to every query
        a = attn.gqa_forward(lp["attn"], self.cfg, _ln(lp["ln1"], h),
                             positions, rope=False, prefix_len=h.shape[1])
        h = h + a
        return h + ffn_apply(lp["ffn"], _ln(lp["ln2"], h), "gelu_mlp")

    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, Sf, D) precomputed frame embeddings (stub)."""
        cfg = self.cfg
        B, Sf, D = frames.shape
        pd = cfg.param_dtype
        x = frames.to(pd) + sinusoids(Sf, D, device=frames.device).to(pd)
        positions = torch.arange(Sf, device=x.device)[None].expand(B, Sf)
        block = remat(self._enc_block, "nothing_saveable")
        for lp in params["enc_layers"]:
            x = block(lp, x, positions)
        return _ln(params["ln_enc"], x)

    def _cross_kv(self, lp, enc_out: torch.Tensor):
        cfg = self.cfg
        B, Sf, _ = enc_out.shape
        dh, kv = cfg.head_dim, cfg.n_kv_heads
        k = dense(lp["xattn"]["k"], enc_out).reshape(B, Sf, kv, dh)
        v = dense(lp["xattn"]["v"], enc_out).reshape(B, Sf, kv, dh)
        return k, v

    # ---------------------------------------------------------- decoder
    def _dec_block(self, lp, h: torch.Tensor, enc: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        a = attn.gqa_forward(lp["attn"], cfg, _ln(lp["ln1"], h), positions,
                             rope=False)
        h = h + a
        a = attn.gqa_forward(lp["xattn"], cfg, _ln(lp["ln_x"], h),
                             positions, rope=False,
                             kv_override=self._cross_kv(lp, enc))
        h = h + a
        return h + ffn_apply(lp["ffn"], _ln(lp["ln2"], h), "gelu_mlp")

    def forward(self, params, tokens: torch.Tensor, frames: torch.Tensor,
                *, last_only: bool = False) -> torch.Tensor:
        """tokens (B,S), frames (B,Sf,D) -> logits (B,S,V)."""
        B, S = tokens.shape
        enc = self.encode(params, frames)
        x = F.embedding(tokens, params["embed"])
        x = x + params["pos_dec"][:S][None]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        block = remat(self._dec_block, "nothing_saveable")
        for lp in params["dec_layers"]:
            x = block(lp, x, enc, positions)
        x = _ln(params["ln_dec"], x)
        if last_only:
            x = x[:, -1:, :]
        return x @ params["embed"].T          # tied head

    def loss(self, params, batch: dict):
        """batch: tokens, labels, frames and an optional mask ->
        (loss, {})."""
        logits = self.forward(params, batch["tokens"], batch["frames"])
        return softmax_xent(logits, batch["labels"], batch.get("mask")), {}

    # ----------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int, *, device=None) -> dict:
        """Per decoder layer a self-attention cache of ``max_len``
        positions; the cross K/V of every layer, (L, B, Sf, KV, Dh) each,
        zeros until :meth:`prefill_cross`."""
        cfg = self.cfg
        dev = resolve(device)
        L = cfg.n_layers
        shape = (L, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        return {
            "self": [attn.gqa_init_cache(cfg, batch, max_len, device=dev)
                     for _ in range(L)],
            "cross_k": torch.zeros(shape, dtype=cfg.param_dtype, device=dev),
            "cross_v": torch.zeros(shape, dtype=cfg.param_dtype, device=dev),
        }

    def prefill_cross(self, params, cache: dict,
                      frames: torch.Tensor) -> dict:
        """Compute the encoder + per-layer cross K/V once per request
        batch, written into ``cache`` in place."""
        enc = self.encode(params, frames)
        for i, lp in enumerate(params["dec_layers"]):
            k, v = self._cross_kv(lp, enc)
            cache["cross_k"][i].copy_(k)
            cache["cross_v"][i].copy_(v)
        return cache

    def decode_step(self, params, cache: dict, tokens: torch.Tensor,
                    pos: int):
        """tokens (B,1), pos absolute position -> (logits (B,1,V), cache);
        the self-attention caches are written in place."""
        cfg = self.cfg
        pos = int(pos)
        x = F.embedding(tokens, params["embed"])
        x = x + params["pos_dec"][pos:pos + 1][None]
        for i, (lp, lc) in enumerate(zip(params["dec_layers"],
                                         cache["self"])):
            a, _ = attn.gqa_decode(lp["attn"], cfg, _ln(lp["ln1"], x), lc,
                                   pos, rope=False)
            x = x + a
            a, _ = attn.gqa_decode(lp["xattn"], cfg, _ln(lp["ln_x"], x),
                                   None, pos, rope=False,
                                   cross_kv=(cache["cross_k"][i],
                                             cache["cross_v"][i]))
            x = x + a
            x = x + ffn_apply(lp["ffn"], _ln(lp["ln2"], x), "gelu_mlp")
        x = _ln(params["ln_dec"], x)
        return x @ params["embed"].T, cache
