"""Decoder-only transformer assembly: dense, MoE(+MLA) and VLM families.

Port of ``repro.models.transformer``.  Covers deepseek-v3-671b and
deepseek-v2-lite-16b (MLA + shared/routed MoE, leading dense layers,
optional multi-token-prediction head), deepseek-coder-33b, qwen3-4b
(qk-norm), olmo-1b (non-parametric LN), qwen2-72b (QKV bias) and
paligemma-3b (MQA gemma backbone + patch-embedding stub, prefix-LM mask).

The reference scans stacked layer axes; here each stack is a list
(``params["dense_layers"]``, then ``params["moe_layers"]``) walked in
Python, and decode caches are preallocated per layer and written in
place.  Under grad each layer of the forward is rematerialised under
``cfg.remat_policy``, as the reference's ``jax.checkpoint`` over its
layer scan does (``models.common.remat``): it changes memory, not
values.  The MoE layers' auxiliary losses are summed per stack, then
over the stacks.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models.common import (ParamSpec, ParamTree, init_params,
                                       layer_norm, remat, rms_norm,
                                       softmax_xent)
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import (ffn_apply, ffn_specs, moe_apply,
                                    moe_specs)


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
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"TransformerModel takes the dense, moe and vlm "
                             f"families, got {cfg.family!r}")
        self.cfg = cfg
        self.n_moe_layers = (cfg.n_layers - cfg.n_dense_layers
                             if cfg.moe else 0)
        self.n_dense_stack = (cfg.n_dense_layers if cfg.moe
                              else cfg.n_layers)
        # text positions start after the patch prefix (vlm)
        self.prefix = cfg.n_patch_tokens if cfg.family == "vlm" else 0

    # ------------------------------------------------------------ specs
    def _attn_specs(self) -> dict:
        return (attn.mla_specs(self.cfg) if self.cfg.mla
                else attn.gqa_specs(self.cfg))

    def _layer_specs(self, moe: bool) -> dict:
        cfg = self.cfg
        ffn = (moe_specs(cfg) if moe
               else ffn_specs(cfg.d_model, cfg.d_ff, cfg.act,
                              cfg.param_dtype))
        return {"ln1": norm_specs(cfg), "attn": self._attn_specs(),
                "ln2": norm_specs(cfg), "ffn": ffn}

    def _stacks(self):
        """(params key, cache key, MoE?, layers) of each non-empty layer
        stack, in the order the layers run."""
        stacks = (("dense_layers", "dense", False, self.n_dense_stack),
                  ("moe_layers", "moe", True, self.n_moe_layers))
        return [st for st in stacks if st[3] > 0]

    def param_specs(self) -> dict:
        cfg = self.cfg
        dtp = cfg.param_dtype
        s = {
            "embed": ParamSpec((cfg.vocab_size, cfg.d_model), init="embed",
                               dtype=dtp),
            "final_norm": norm_specs(cfg),
        }
        for key, _, moe, n in self._stacks():
            s[key] = [self._layer_specs(moe) for _ in range(n)]
        if not cfg.tie_embeddings:
            s["head"] = ParamSpec((cfg.d_model, cfg.vocab_size), dtype=dtp)
        if cfg.family == "vlm":
            # frontend is a stub: a single linear adapting patch embeddings
            s["patch_proj"] = ParamSpec((cfg.d_model, cfg.d_model),
                                        dtype=dtp)
        if cfg.mtp:
            s["mtp"] = {
                "proj": ParamSpec((2 * cfg.d_model, cfg.d_model), dtype=dtp),
                "block": self._layer_specs(False),
                "norm_h": norm_specs(cfg), "norm_e": norm_specs(cfg),
            }
        return s

    def init(self, seed: int = 0, *, device=None) -> ParamTree:
        """Random weights from a ``torch.Generator`` seeded with ``seed``,
        drawn on ``device`` (None: the card; raises without one)."""
        return init_params(self.param_specs(), seed=seed,
                           device=resolve(device))

    # ----------------------------------------------------------- blocks
    def _ffn(self, lp, h: torch.Tensor, moe: bool):
        """h + the layer's FFN (dense or MoE) -> (h, aux loss or None)."""
        cfg = self.cfg
        xn = apply_norm(lp["ln2"], cfg, h)
        if moe:
            f, aux = moe_apply(lp["ffn"], cfg, xn)
            return h + f, aux
        return h + ffn_apply(lp["ffn"], xn, cfg.act), None

    def _block(self, lp, x: torch.Tensor, positions: torch.Tensor,
               moe: bool, prefix_len: int = 0):
        """One layer of the forward -> (x, aux float32 scalar)."""
        cfg = self.cfg
        xn = apply_norm(lp["ln1"], cfg, x)
        if cfg.mla:
            a = attn.mla_forward(lp["attn"], cfg, xn, positions)
        else:
            a = attn.gqa_forward(lp["attn"], cfg, xn, positions,
                                 window=cfg.sliding_window,
                                 prefix_len=prefix_len)
        x, aux = self._ffn(lp, x + a, moe)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux

    def _embed_inputs(self, params, tokens: torch.Tensor, patches=None):
        x = F.embedding(tokens, params["embed"])
        if self.cfg.family == "vlm":
            if patches is None:
                raise ValueError(f"{self.cfg.name}: the vlm forward takes "
                                 f"patch embeddings (B, n_patch_tokens, D)")
            x = self._gemma_scale(x)
            pe = patches.to(x.dtype) @ params["patch_proj"]
            x = torch.cat([pe, x], dim=1)
        return x

    def _gemma_scale(self, x: torch.Tensor) -> torch.Tensor:
        """x * sqrt(d_model), the factor rounded to x's dtype first."""
        return x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype,
                                device=x.device)

    def forward(self, params, tokens: torch.Tensor, patches=None, *,
                last_only: bool = False):
        """tokens (B,S) [+ patches (B,Np,D) for vlm] -> (logits, aux,
        final hidden of the text positions).  last_only=True: logits of
        the final position only.  Under grad each layer is rematerialised
        under ``cfg.remat_policy``."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self._embed_inputs(params, tokens, patches)
        St = x.shape[1]
        positions = torch.arange(St, device=x.device)[None].expand(B, St)
        layer = remat(self._block, cfg.remat_policy)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for key, _, moe, _ in self._stacks():
            stack_aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for lp in params[key]:
                x, a = layer(lp, x, positions, moe, self.prefix)
                stack_aux = stack_aux + a
            aux = aux + stack_aux
        x = apply_norm(params["final_norm"], cfg, x)
        if self.prefix:
            x = x[:, -S:, :]
        if last_only:
            x = x[:, -1:, :]
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
        """batch: tokens (B, S), labels (B, S), an optional mask and, for
        vlm, patches, as tensors on the params' device -> (loss, metrics):
        the next-token cross-entropy plus the routers' auxiliary loss
        (0 without MoE) plus, with ``cfg.mtp``, the weighted
        multi-token-prediction loss; metrics {"xent", "aux"[, "mtp"]}."""
        cfg = self.cfg
        logits, aux, h = self.forward(params, batch["tokens"],
                                      batch.get("patches"))
        main = softmax_xent(logits, batch["labels"], batch.get("mask"))
        metrics = {"xent": main, "aux": aux}
        total = main + aux
        if cfg.mtp:
            total = total + self._mtp_loss(params, batch, h, metrics)
        return total, metrics

    def _mtp_loss(self, params, batch: dict, h: torch.Tensor,
                  metrics: dict) -> torch.Tensor:
        """DeepSeek-V3 multi-token prediction (depth 1): predict t_{i+2}
        from [norm(h_i); norm(emb(t_{i+1}))] through one extra block."""
        cfg = self.cfg
        p = params["mtp"]
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        # labels are the shift-by-1 stream: emb of t_{i+1} = emb(labels)
        e = F.embedding(labels, params["embed"])
        hh = torch.cat([apply_norm(p["norm_h"], cfg, h),
                        apply_norm(p["norm_e"], cfg, e)], dim=-1)
        hh = hh @ p["proj"]
        positions = torch.arange(S, device=hh.device)[None].expand(B, S)
        hh, _ = self._block(p["block"], hh, positions, False)
        logits2 = self._logits(params, hh)
        # target: t_{i+2} = labels shifted left by one
        tgt = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
        mask = batch.get("mask")
        m2 = (torch.ones((B, S), dtype=torch.float32, device=hh.device)
              if mask is None else mask.clone())
        m2[:, -1] = 0.0
        mtp = softmax_xent(logits2, tgt, m2)
        metrics["mtp"] = mtp
        return cfg.mtp_loss_coef * mtp

    # ----------------------------------------------------------- decode
    def _init_layer_cache(self, batch: int, max_len: int, dev) -> dict:
        cfg = self.cfg
        if cfg.mla:
            return attn.mla_init_cache(cfg, batch, max_len, device=dev)
        return attn.gqa_init_cache(cfg, batch, max_len,
                                   window=cfg.sliding_window, device=dev)

    def init_cache(self, batch: int, max_len: int, *, device=None) -> dict:
        """Per-layer caches of each stack, preallocated for ``max_len``
        positions (plus the patch prefix for vlm)."""
        dev = resolve(device)
        max_len = max_len + self.prefix
        return {ck: [self._init_layer_cache(batch, max_len, dev)
                     for _ in range(n)]
                for _, ck, _, n in self._stacks()}

    def _decode_layer(self, lp, lc, x: torch.Tensor, pos: int,
                      moe: bool) -> torch.Tensor:
        cfg = self.cfg
        xn = apply_norm(lp["ln1"], cfg, x)
        if cfg.mla:
            a, _ = attn.mla_decode(lp["attn"], cfg, xn, lc, pos)
        else:
            a, _ = attn.gqa_decode(lp["attn"], cfg, xn, lc, pos,
                                   window=cfg.sliding_window)
        return self._ffn(lp, x + a, moe)[0]

    def decode_step(self, params, cache: dict, tokens: torch.Tensor,
                    pos: int):
        """tokens (B,1), pos absolute text position -> (logits (B,1,V),
        cache); the cache is written in place (vlm: at pos + the patch
        prefix)."""
        cfg = self.cfg
        x = F.embedding(tokens, params["embed"])
        if cfg.family == "vlm":
            x = self._gemma_scale(x)
        pos = int(pos) + self.prefix
        for key, ck, moe, _ in self._stacks():
            for lp, lc in zip(params[key], cache[ck]):
                x = self._decode_layer(lp, lc, x, pos, moe)
        x = apply_norm(params["final_norm"], cfg, x)
        return self._logits(params, x), cache

    def prefill(self, params, cache: dict, tokens: torch.Tensor):
        """Prompt prefill from an EMPTY cache: fills every layer's cache
        with the values the per-token decode loop would write for
        positions 0..S-1, in one full-sequence pass.  Returns
        (last-position logits (B,1,V), cache).

        Text-only entry (no patch embeddings): on vlm configs the patch
        slots stay unwritten, matching a decode loop that never fed
        patches — the greedy serve path's behaviour."""
        cfg = self.cfg
        x = F.embedding(tokens, params["embed"])
        if cfg.family == "vlm":
            x = self._gemma_scale(x)
        for key, ck, moe, _ in self._stacks():
            for lp, lc in zip(params[key], cache[ck]):
                xn = apply_norm(lp["ln1"], cfg, x)
                if cfg.mla:
                    a, _ = attn.mla_prefill(lp["attn"], cfg, xn, lc)
                else:
                    a, _ = attn.gqa_prefill(lp["attn"], cfg, xn, lc,
                                            window=cfg.sliding_window,
                                            pos_offset=self.prefix)
                x = self._ffn(lp, x + a, moe)[0]
        x = apply_norm(params["final_norm"], cfg, x[:, -1:, :])
        return self._logits(params, x), cache
