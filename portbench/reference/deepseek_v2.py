"""DeepSeek-V2 (DeepSeek-AI, 2024, arXiv:2405.04434; DeepSeek-V2-Lite's
published config.json and modeling code), plain float32 PyTorch:

  x = embed[token]; per layer, pre-norm (RMSNorm, eps 1e-6, a scale):
  MLA, no query compression:
    q = h W_q -> per head [q_nope (128); q_rope (64)]
    [c; k_rope] = h W_dkv ;  c = RMSNorm(c) (rank 512)
    k_nope = c W_uk, v = c W_uv (per head 128 and 128)
    q_rope, k_rope rotated by YaRN's RoPE (theta 10000, factor 40 over
    4096 positions, beta_fast 32, beta_slow 1; k_rope shared by the heads)
    softmax((q_nope k_nope + q_rope k_rope) * 192^-0.5 * m^2) v, then W_o
    with m = 0.1 * mscale_all_dim * ln(factor) + 1
  then the feed-forward: SwiGLU (silu(h W_gate) * h W_up) W_down in the
  first ``n_dense_layers`` layers; in the others softmax routing over the
  experts (router in float32), the ``top_k`` largest gates (greedy, not
  renormalised unless ``norm_topk_prob``, times
  ``routed_scaling_factor``), sum_k gate_k * SwiGLU_{e_k}(h), plus the
  shared experts as one SwiGLU of n_shared x d_expert; logits =
  RMSNorm(x) head (untied).

Computed layer after layer over every sequence at once, each layer's
weights upcast to float32 only while it runs; the routed experts expert
by expert over the tokens routed to them (no capacity, nothing dropped).

Departures from the published code: the 64 rope dims rotate in pairs
(i, i + 32) (the port's layout) where the published code pairs (2i,
2i + 1) after a reshape: a fixed permutation of W_q's and W_dkv's rope
columns, which random weights cannot tell apart.  The cos/sin factor
m(mscale) / m(mscale_all_dim) is 1 with the published equal values.

Weights: ``embed`` (V, d); ``dense_layers[i]`` / ``moe_layers[i]`` with
``ln1/scale``, ``ln2/scale``, ``attn/{q (d, H, 192), dkv/kernel (d, 576),
kv_norm (512), uk (512, H, 128), uv (512, H, 128), o/kernel (H 128, d)}``
and ``ffn``: ``{gate, up, down}`` (dense) or ``{router (d, E),
experts/{gate, up (E, d, f), down (E, f, d)}, shared/{gate, up, down}}``;
``final_norm/scale``; ``head`` (d, V).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.common import exact_float32, mm

#: RMSNorm's epsilon (the published ``rms_norm_eps``)
EPS = 1e-6


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * scale


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * float(np.log(factor)) + 1.0


def yarn_inv_freq(dim: int, theta: float, rs: dict) -> torch.Tensor:
    """DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding`` frequencies."""
    base = theta ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    extra, inter = 1.0 / base, 1.0 / (rs["factor"] * base)
    orig = rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * np.log(orig / (rot * 2 * np.pi)) / (2 * np.log(theta))
    low = max(int(np.floor(corr(rs["beta_fast"]))), 0)
    high = min(int(np.ceil(corr(rs["beta_slow"]))), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return (inter * (1 - mask) + extra * mask).float()


def _rope(x: torch.Tensor, pos: torch.Tensor, inv: torch.Tensor,
          cs: float) -> torch.Tensor:
    """x (N, ..., D) rotated at positions ``pos`` (N,), pairs (i, i + D/2)."""
    ang = pos[:, None].float() * inv                          # (N, D/2)
    cos, sin = torch.cos(ang) * cs, torch.sin(ang) * cs
    if x.dim() == 3:
        cos, sin = cos[:, None], sin[:, None]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(p, h, model, bounds, pos, precision):
    N, d = h.shape
    H, c = model["n_heads"], model["kv_lora_rank"]
    dn, dr, dv = (model["nope_head_dim"], model["rope_head_dim"],
                  model["v_head_dim"])
    rs = dict(model["rope_scaling"])
    theta = model["rope_theta"]
    inv = yarn_inv_freq(dr, theta, rs).to(h.device)
    cs = (_mscale(rs["factor"], rs["mscale"])
          / _mscale(rs["factor"], rs["mscale_all_dim"]))
    m = _mscale(rs["factor"], rs["mscale_all_dim"])
    scale = (dn + dr) ** -0.5 * m * m
    q = mm(h, p["q"].reshape(d, H * (dn + dr)), precision).view(N, H,
                                                                 dn + dr)
    kv = mm(h, p["dkv"]["kernel"], precision)
    ckv = _rms(kv[:, :c], p["kv_norm"])
    k_pe = _rope(kv[:, c:], pos, inv, cs)
    q_nope, q_pe = q[..., :dn], _rope(q[..., dn:], pos, inv, cs)
    k_nope = mm(ckv, p["uk"].reshape(c, H * dn), precision).view(N, H, dn)
    v = mm(ckv, p["uv"].reshape(c, H * dv), precision).view(N, H, dv)
    out = torch.empty((N, H, dv), dtype=torch.float32, device=h.device)
    for a, b in bounds:
        s = (torch.einsum("qhd,khd->hqk", q_nope[a:b], k_nope[a:b])
             + torch.einsum("qhd,kd->hqk", q_pe[a:b], k_pe[a:b])) * scale
        T = b - a
        causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
        pr = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        out[a:b] = torch.einsum("hqk,khd->qhd", pr, v[a:b])
    return mm(out.view(N, H * dv), p["o"]["kernel"], precision)


def _swiglu(x, w_gate, w_up, w_down, precision):
    return mm(_silu(mm(x, w_gate, precision)) * mm(x, w_up, precision),
              w_down, precision)


def _moe(p, h, model, precision):
    E, K = model["n_routed_experts"], model["top_k"]
    probs = torch.softmax(mm(h, p["router"], precision), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :K], idx[:, :K]
    if model["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    gates = gates * model["routed_scaling_factor"]
    ex = p["experts"]
    out = torch.zeros_like(h)
    for e in range(E):
        tok, k = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(h[tok], ex["gate"][e], ex["up"][e], ex["down"][e],
                    precision)
        out.index_add_(0, tok, y * gates[tok, k, None])
    sh = p["shared"]
    return out + _swiglu(h, sh["gate"], sh["up"], sh["down"], precision)


def _float(tree):
    if isinstance(tree, dict):
        return {k: _float(v) for k, v in tree.items()}
    return tree.float()


def logits(weights: dict, model: dict, seqs: list, positions: list, *,
           precision: str = "float32", device=None) -> list:
    """Float32 logits (len(positions[i]), V) of each token sequence
    ``seqs[i]`` at its ``positions[i]``, from one causal forward over the
    whole sequence (no cache)."""
    device = device or weights["embed"].device
    lens = [len(s) for s in seqs]
    ends = np.cumsum(lens).tolist()
    bounds = list(zip([0] + ends[:-1], ends))
    with torch.inference_mode(), exact_float32():
        tok = torch.from_numpy(np.concatenate(seqs).astype(np.int64)).to(
            device)
        pos = torch.cat([torch.arange(n, device=device) for n in lens])
        x = weights["embed"][tok].float()
        layers = [(p, False) for p in weights.get("dense_layers", [])] + [
            (p, True) for p in weights.get("moe_layers", [])]
        for raw, is_moe in layers:
            p = _float(raw)
            x = x + _attention(p["attn"], _rms(x, p["ln1"]["scale"]), model,
                               bounds, pos, precision)
            hn = _rms(x, p["ln2"]["scale"])
            f = p["ffn"]
            x = x + (_moe(f, hn, model, precision) if is_moe else
                     _swiglu(hn, f["gate"], f["up"], f["down"], precision))
            del p
        x = _rms(x, weights["final_norm"]["scale"].float())
        head = weights["head"].float()
        return [mm(x[a + torch.as_tensor(np.asarray(ps), device=device)],
                   head, precision) for (a, _), ps in zip(bounds, positions)]
