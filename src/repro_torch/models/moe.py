"""Feed-forward blocks: the dense FFN and the Mixture-of-Experts FFN of
``repro.models.moe`` (DeepSeek-V2/V3 family).

Two routing paths, chosen by ``ModelConfig.moe_dropless``:

* GShard (the default, ``moe_dropless=False``): the reference's
  capacity-bounded dispatch below, kept as it is so that every config
  equals the reference's (ROADMAP C1);
* dropless (``moe_dropless=True``, port-only): DeepSeek-V2's published
  routing.  Every token goes to its top-k experts with no capacity, each
  routed row is weighted by its own softmax gate (renormalised only with
  ``norm_topk_prob``, times ``routed_scaling_factor``), and the experts
  run through ``kernels.moe.routed_experts``: CUDA kernels on the card
  (``csrc/moe.cu``) that read only the experts some token picked, their
  plain versions on the CPU.  The rows each expert gets are added to the device counter
  ``kernels.moe.ROWS_COUNTER`` per (layer, expert).

shared experts:  always-on dense FFN(s) (deepseek: 1 (v3) / 2 (v2-lite)),
                 matrix products outside any kernel on both paths.
routed experts (GShard):  top-k of E, dispatched with the GShard formulation —
                 one-hot dispatch/combine tensors, capacity-bounded per
                 *group* of tokens (the dispatch tensor is (G, g, E, C)).
                 The experts run as batched matrix products over the
                 expert axis: every expert over its C slots, as the
                 reference's einsums do (no Pallas kernel there either).

GShard's router: softmax gating with top-k renormalisation + the Switch
load-balance auxiliary loss (coef cfg.router_aux_coef), logits in float32
from a float32 router.  Ties in the top-k keep the lower expert first, as
``jax.lax.top_k`` does: the top-k is read off a stable descending sort.

The combine tensor is the reference's ``einsum("tec,tk->tec", disp,
gates)``: each kept slot is weighted by the SUM of its token's K
renormalised gates (about 1), not by its own expert's gate.  The port
keeps that as it is (ROADMAP.md queue C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch
from repro_torch.kernels import moe as km
from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ModelConfig


def ffn_specs(d_model: int, d_ff: int, act: str, dt) -> dict:
    s = {
        "up": ParamSpec((d_model, d_ff), dtype=dt),
        "down": ParamSpec((d_ff, d_model), dtype=dt),
    }
    if act in ("silu", "gelu"):          # gated (swiglu / geglu)
        s["gate"] = ParamSpec((d_model, d_ff), dtype=dt)
    return s


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def ffn_apply(p, x: torch.Tensor, act: str) -> torch.Tensor:
    up = x @ p["up"]
    if "gate" in p:
        g = x @ p["gate"]
        h = (F.silu(g) if act == "silu" else _gelu(g)) * up
    else:
        h = _gelu(up)
    return h @ p["down"]


def moe_specs(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_routed_experts, cfg.d_expert
    dt = cfg.param_dtype
    s: dict = {
        "router": ParamSpec((d, e), dtype=torch.float32),
        "experts": {
            "gate": ParamSpec((e, d, f), dtype=dt),
            "up": ParamSpec((e, d, f), dtype=dt),
            "down": ParamSpec((e, f, d), dtype=dt),
        },
    }
    if cfg.n_shared_experts > 0:
        s["shared"] = ffn_specs(d, cfg.d_expert * cfg.n_shared_experts,
                                cfg.act, dt)
    return s


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n, dtype=dtype)``: a comparison, with no
    range check (``F.one_hot``'s waits for the card on CUDA tensors)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k(probs: torch.Tensor, K: int):
    """(values, indices) of the K largest along the last axis, largest
    first and, among equal values, the lower index first
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :K], idx[..., :K]


def _route(logits: torch.Tensor, K: int, E: int, aux_coef: float):
    """Routing per group: logits (..., Tg, E) float32 -> (gates (..., Tg,
    K), idx (..., Tg, K), aux (...,)), the leading axes the groups."""
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = top_k(probs, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss
    me = probs.mean(dim=-2)                                  # (..., E)
    ce = _one_hot(idx[..., 0], E, torch.float32).mean(dim=-2)
    aux = aux_coef * E * (me * ce).sum(dim=-1)
    return gate_vals, idx, aux


def _dispatch_combine(idx: torch.Tensor, gate_vals: torch.Tensor, E: int,
                      C: int, dtype: torch.dtype):
    """One-hot dispatch (..., Tg, E, C) and combine (..., Tg, E, C)
    tensors of each group.  An assignment's slot is its queue position in
    its expert, counted token-major then k; one at position C or later is
    dropped (it keeps slot 0 and is masked out by ``keep``)."""
    *lead, Tg, K = idx.shape
    sel = _one_hot(idx, E, torch.int32)                      # (..,Tg,K,E)
    pos_in_e = (torch.cumsum(sel.reshape(*lead, Tg * K, E), dim=-2)
                .reshape(sel.shape) - 1)                     # queue position
    keep = (pos_in_e < C) & (sel > 0)
    slot = torch.where(keep, pos_in_e, 0).amax(dim=-1)       # (..., Tg, K)
    slot_oh = _one_hot(slot, C, dtype)                       # (..,Tg,K,C)
    disp = torch.einsum("...tke,...tkc->...tec", keep.to(dtype), slot_oh)
    # the reference's einsum("tec,tk->tec"): k summed out of the gates
    gsum = gate_vals.to(dtype).to(torch.float32).sum(dim=-1).to(dtype)
    comb = disp * gsum[..., None, None]
    return disp, comb


def _group_size(T: int, target: int = 512) -> int:
    """Largest divisor of T that is <= target (token-group size)."""
    g = min(target, T)
    while T % g:
        g -= 1
    return g


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor, layer: int = 0):
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux loss float32).
    ``layer``: the layer's index in the model (the dropless path's row
    counter).  GShard: groups are fixed-size chunks of the flattened
    tokens; capacity C = max(1, int(capacity_factor * K * g / E)) slots
    an expert a group."""
    if cfg.moe_dropless:
        return _moe_dropless(p, cfg, x, layer)
    B, S, D = x.shape
    E, K = cfg.n_routed_experts, cfg.top_k
    T = B * S
    g = _group_size(T, getattr(cfg, "moe_group_size", 512))
    G = T // g
    C = max(1, int(cfg.capacity_factor * K * g / E))
    dt = x.dtype
    xg = x.reshape(G, g, D)

    logits = xg.to(torch.float32) @ p["router"]              # (G, g, E)
    gate_vals, idx, aux = _route(logits, K, E, cfg.router_aux_coef)
    disp, comb = _dispatch_combine(idx, gate_vals, E, C, dt)

    # dispatch tokens: (G, t, E, C) x (G, t, D) -> (E, G*C, D)
    ex_in = torch.einsum("gtec,gtd->gecd", disp, xg)
    ex_in = ex_in.permute(1, 0, 2, 3).reshape(E, G * C, D)

    w = p["experts"]
    gate_h = torch.bmm(ex_in, w["gate"])
    up_h = torch.bmm(ex_in, w["up"])
    h = (F.silu(gate_h) if cfg.act == "silu" else _gelu(gate_h)) * up_h
    ex_out = torch.bmm(h, w["down"])
    ex_out = ex_out.reshape(E, G, C, D).permute(1, 0, 2, 3)  # (G,E,C,D)

    out = torch.einsum("gtec,gecd->gtd", comb, ex_out).reshape(B, S, D)
    if "shared" in p:
        out = out + ffn_apply(p["shared"], x, cfg.act)
    return out.to(dt), aux.mean()


def _moe_dropless(p, cfg: ModelConfig, x: torch.Tensor, layer: int):
    """The published routing (see the module): router logits in float32
    from a float32 router, the routed experts' sum in float32, plus the
    shared experts, rounded once to x's dtype.  A serving path: the aux
    loss is 0 (DeepSeek-V2's sequence-wise balance loss is not ported, and
    the kernels have no backward)."""
    B, S, D = x.shape
    E = cfg.n_routed_experts
    xt = x.reshape(B * S, D)
    logits = xt.to(torch.float32) @ p["router"]
    rows = dispatch.device_counter(km.ROWS_COUNTER, (cfg.n_layers, E),
                                   x.device)
    w = p["experts"]
    out, _, _ = km.routed_experts(
        xt, logits, w["gate"], w["up"], w["down"], top_k=cfg.top_k,
        norm_topk=cfg.norm_topk_prob, scale=cfg.routed_scaling_factor,
        counter=rows[layer])
    if "shared" in p:
        out = out + ffn_apply(p["shared"], xt, cfg.act).to(torch.float32)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return out.to(x.dtype).reshape(B, S, D), aux
