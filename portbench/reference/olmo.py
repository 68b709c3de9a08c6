"""OLMo (Groeneveld et al., 2024, arXiv:2402.00838), plain float32
PyTorch from the published description: a pre-norm decoder with
non-parametric LayerNorm (no scale, no bias, eps 1e-5), multi-head
attention with rotary embeddings on the query and key halves
(x1 cos - x2 sin, x1 sin + x2 cos; theta 10000), causal softmax at
scale 1/sqrt(D), SwiGLU feed-forward (silu(x W_gate) * x W_up) W_down,
no biases, the output head tied to the token embedding.

Weights (the benchmark's own draw, whatever dtype): ``embed`` (V, d);
``dense_layers[i]`` with ``attn/{q,k,v,o}/kernel`` ((d, H D) x 3,
(H D, d)) and ``ffn/{gate,up,down}`` ((d, ff) x 2, (ff, d)).
"""

from __future__ import annotations

import torch

from portbench.reference.common import (blocks, exact_float32, layer_norm,
                                        mm, padded)

#: float32 elements one block of sequences may hold in its largest
#: intermediate (the attention scores or the feed-forward's hidden)
BLOCK_ELEMENTS = 1.5e9


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, D) float32 rotated at positions 0 .. T-1."""
    T, D = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float32,
                                  device=x.device) / D)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(p, x, model, precision):
    B, T, d = x.shape
    H, KV = model["n_heads"], model["n_kv_heads"]
    D = model.get("d_head") or d // H
    q = mm(x, p["q"]["kernel"], precision).view(B, T, H, D)
    k = mm(x, p["k"]["kernel"], precision).view(B, T, KV, D)
    v = mm(x, p["v"]["kernel"], precision).view(B, T, KV, D)
    theta = model.get("rope_theta", 10000.0)
    q, k = _rope(q, theta), _rope(k, theta)
    g = H // KV
    k, v = (t.repeat_interleave(g, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, T, H * D)
    return mm(o, p["o"]["kernel"], precision)


def _ffn(p, x, precision):
    h = (torch.nn.functional.silu(mm(x, p["gate"], precision))
         * mm(x, p["up"], precision))
    return mm(h, p["down"], precision)


def logits(weights: dict, model: dict, seqs: list, positions: list, *,
           precision: str = "float32", device=None) -> list:
    """Float32 logits (len(positions[i]), V) of each token sequence
    ``seqs[i]`` at its ``positions[i]``, from one causal forward over the
    whole sequence (no cache)."""
    device = device or weights["embed"].device
    H, ff = model["n_heads"], model["d_ff"]
    out: list = [None] * len(seqs)
    budget = BLOCK_ELEMENTS

    def cost(rows, T):
        return rows * T * max(H * T, ff)

    with torch.inference_mode(), exact_float32():
        emb = weights["embed"]
        head = emb.float().T
        for idx in blocks(seqs, budget, cost):
            tok = padded(seqs, idx, device)
            x = emb[tok].float()
            for p in weights["dense_layers"]:
                x = x + _attention(p["attn"], layer_norm(x), model,
                                   precision)
                x = x + _ffn(p["ffn"], layer_norm(x), precision)
            x = layer_norm(x)
            for r, i in enumerate(idx):
                pos = torch.as_tensor(positions[i], device=device)
                out[i] = mm(x[r, pos], head, precision)
    return out
