"""Decoder-only transformer, dense family: olmo-1b (non-parametric LN),
qwen3-4b (qk-norm), qwen2-72b (QKV bias), deepseek-coder-33b (GQA).

The dense half of ``repro.models.transformer``.  The reference scans a
stacked layer axis; here the layers are a list (``params["dense_layers"]``)
walked in Python, and decode caches are preallocated per layer and
written in place.  Under grad each layer of the forward is
rematerialised under ``cfg.remat_policy``, as the reference's
``jax.checkpoint`` over its layer scan does (``models.common.remat``):
it changes memory, not values.  MLA, MoE (with its auxiliary loss),
multi-token prediction and the vlm family are not ported yet: ROADMAP.md
queue A, item A6.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models.common import (ParamSpec, ParamTree, init_params,
                                       layer_norm, remat, rms_norm,
                                       softmax_xent)
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import ffn_apply, ffn_specs


# ------------------------------------------------------------------- norms
def norm_specs(cfg: ModelConfig) -> dict:
    dtp = cfg.param_dtype
    if cfg.norm == "nonparam_ln":
        return {}
    s = {"scale": ParamSpec((cfg.d_model,), init="ones", dtype=dtp)}
    if cfg.norm == "layernorm":
        s["bias"] = ParamSpec((cfg.d_model,), init="zeros", dtype=dtp)
    return s


def apply_norm(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["scale"])
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return layer_norm(x, None, None)        # olmo non-parametric


class TransformerModel:
    def __init__(self, cfg: ModelConfig):
        if cfg.mla or cfg.moe or cfg.family == "vlm":
            raise NotImplementedError(
                f"{cfg.name}: MLA, MoE and the vlm family are not ported to "
                f"repro_torch yet: ROADMAP.md queue A, item A6")
        if cfg.family != "dense":
            raise ValueError(f"TransformerModel takes the dense family, "
                             f"got {cfg.family!r}")
        self.cfg = cfg

    # ------------------------------------------------------------ specs
    def _layer_specs(self) -> dict:
        cfg = self.cfg
        return {"ln1": norm_specs(cfg), "attn": attn.gqa_specs(cfg),
                "ln2": norm_specs(cfg),
                "ffn": ffn_specs(cfg.d_model, cfg.d_ff, cfg.act,
                                 cfg.param_dtype)}

    def param_specs(self) -> dict:
        cfg = self.cfg
        dtp = cfg.param_dtype
        s = {
            "embed": ParamSpec((cfg.vocab_size, cfg.d_model), init="embed",
                               dtype=dtp),
            "final_norm": norm_specs(cfg),
            "dense_layers": [self._layer_specs()
                             for _ in range(cfg.n_layers)],
        }
        if not cfg.tie_embeddings:
            s["head"] = ParamSpec((cfg.d_model, cfg.vocab_size), dtype=dtp)
        return s

    def init(self, seed: int = 0, *, device=None) -> ParamTree:
        """Random weights from a ``torch.Generator`` seeded with ``seed``,
        drawn on ``device`` (None: the card; raises without one)."""
        return init_params(self.param_specs(), seed=seed,
                           device=resolve(device))

    # ----------------------------------------------------------- blocks
    def _ffn(self, lp, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return h + ffn_apply(lp["ffn"], apply_norm(lp["ln2"], cfg, h),
                             cfg.act)

    def _layer(self, lp, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        xn = apply_norm(lp["ln1"], cfg, x)
        x = x + attn.gqa_forward(lp["attn"], cfg, xn, positions,
                                 window=cfg.sliding_window)
        return self._ffn(lp, x)

    def forward(self, params, tokens: torch.Tensor, *,
                last_only: bool = False):
        """tokens (B,S) -> (logits, aux, final hidden).  last_only=True:
        logits of the final position only.  Under grad each layer is
        rematerialised under ``cfg.remat_policy``."""
        cfg = self.cfg
        B, S = tokens.shape
        x = F.embedding(tokens, params["embed"])
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        layer = remat(self._layer, cfg.remat_policy)
        for lp in params["dense_layers"]:
            x = layer(lp, x, positions)
        x = apply_norm(params["final_norm"], cfg, x)
        if last_only:
            x = x[:, -1:, :]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._logits(params, x), aux, x

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.tie_embeddings:
            logits = x @ params["embed"].T
        else:
            logits = x @ params["head"]
        if cfg.logit_softcap > 0:
            c = cfg.logit_softcap
            logits = torch.tanh(logits / c) * c
        return logits

    def loss(self, params, batch: dict):
        """batch: tokens (B, S), labels (B, S) and an optional mask, as
        tensors on the params' device -> (loss, {"xent", "aux"}); aux is
        0 for the dense family (no router)."""
        logits, aux, _ = self.forward(params, batch["tokens"])
        main = softmax_xent(logits, batch["labels"], batch.get("mask"))
        return main + aux, {"xent": main, "aux": aux}

    # ----------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int, *, device=None) -> dict:
        """Per-layer caches, preallocated for ``max_len`` positions."""
        cfg = self.cfg
        dev = resolve(device)
        return {"dense": [attn.gqa_init_cache(cfg, batch, max_len,
                                              window=cfg.sliding_window,
                                              device=dev)
                          for _ in range(cfg.n_layers)]}

    def decode_step(self, params, cache: dict, tokens: torch.Tensor,
                    pos: int):
        """tokens (B,1), pos absolute position -> (logits (B,1,V), cache);
        the cache is written in place."""
        cfg = self.cfg
        x = F.embedding(tokens, params["embed"])
        for lp, lc in zip(params["dense_layers"], cache["dense"]):
            xn = apply_norm(lp["ln1"], cfg, x)
            a, _ = attn.gqa_decode(lp["attn"], cfg, xn, lc, pos,
                                   window=cfg.sliding_window)
            x = self._ffn(lp, x + a)
        x = apply_norm(params["final_norm"], cfg, x)
        return self._logits(params, x), cache

    def prefill(self, params, cache: dict, tokens: torch.Tensor):
        """Prompt prefill from an EMPTY cache: fills every layer's cache
        with the values the per-token decode loop would write for
        positions 0..S-1, in one full-sequence pass.  Returns
        (last-position logits (B,1,V), cache)."""
        cfg = self.cfg
        x = F.embedding(tokens, params["embed"])
        for lp, lc in zip(params["dense_layers"], cache["dense"]):
            xn = apply_norm(lp["ln1"], cfg, x)
            a, _ = attn.gqa_prefill(lp["attn"], cfg, xn, lc,
                                    window=cfg.sliding_window)
            x = self._ffn(lp, x + a)
        x = apply_norm(params["final_norm"], cfg, x[:, -1:, :])
        return self._logits(params, x), cache
