"""RWKV-6 "Finch" (Peng et al., 2024, arXiv:2404.05892), plain float32
PyTorch from the published equations, in the recurrent form, one token
after another:

  x = LN_in(embed[token]); per layer, time mix then channel mix, each
  on LN(x) with the previous token's LN(x) (zeros before the first):
    dx = x_prev - x ;  xxx = x + dx * mu
    x_z = x + dx * (mu_z + tanh(xxx A_z) B_z)        z in r, k, v, g, w
    r, k, v = x_r W_r, x_k W_k, x_v W_v ;  g = silu(x_g W_g)
    w = exp(-exp(w0 + tanh(x_w A_w) B_w))             per channel
    per head (dk = dv = head size), S_0 = 0:
      y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
      S_t = diag(w_t) S_{t-1} + k_t v_t^T
    out = (GroupNorm_heads(y) * gn + gn_b) * g, then W_o
  channel mix: k = relu(x_k W_k)^2 ; out = sigmoid(x_r W_r) * (k W_v)
  logits = LN_out(x) head.

Departures that the served configuration states (``port_constants``):
one LoRA rank for the five token-shift mixes and the decay
(``lora_rank``), and the per-head GroupNorm's ``groupnorm_eps``.

Weights: ``embed``, ``ln_in``/``ln_in_b``, ``layers[i]`` with ``att``
(``ln``, ``ln_b``, ``mu_base``, ``mu_{r,k,v,g,w}``,
``lora_{r,k,v,g,w}/{a,b}``, ``{r,k,v,g,o}/kernel``, ``w0``, ``u``,
``gn``, ``gn_b``) and ``ffn`` (``ln``, ``ln_b``, ``mu_k``, ``mu_r``,
``{k,v,r}/kernel``), ``ln_out``/``ln_out_b``, ``head``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import (blocks, exact_float32, layer_norm,
                                        mm, padded)

#: float32 elements one block may hold in its largest intermediate
BLOCK_ELEMENTS = 1.5e9


def _shift(x: torch.Tensor) -> torch.Tensor:
    """The previous token's row (zeros before the first)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _f(t):
    return t.float()


def _wkv(r, k, v, w, u, dh):
    """The recurrence, token by token: r, k, v, w (B, T, d) -> y (B, T, d);
    u (d,).  y_t is taken as r_t^T S_{t-1} + (r_t . (u * k_t)) v_t, the
    same sum regrouped, so that a step passes over the state three
    times."""
    B, T, d = r.shape
    H = d // dh

    def steps(t):                            # (T, B, H, dh)
        return t.view(B, T, H, dh).transpose(0, 1).contiguous()
    r, k, v, w = map(steps, (r, k, v, w))
    bonus = (r * u.view(H, dh) * k).sum(-1, keepdim=True)
    S = torch.zeros(B, H, dh, dh, dtype=torch.float32, device=r.device)
    y = torch.empty_like(v)
    for t in range(T):
        y[t] = torch.einsum("bhi,bhij->bhj", r[t], S) + bonus[t] * v[t]
        S = torch.addcmul(S * w[t, ..., None], k[t, ..., None],
                          v[t, :, :, None, :])
    return y.transpose(0, 1).reshape(B, T, d)


def _time_mix(p, x, model, precision):
    eps_gn = model["groupnorm_eps"]
    dh = model["rwkv_head_dim"]
    xn = layer_norm(x, p["ln"], p["ln_b"])
    dx = _shift(xn) - xn
    xxx = xn + dx * _f(p["mu_base"])

    def lerp(z):
        lo = p[f"lora_{z}"]
        m = mm(torch.tanh(mm(xxx, lo["a"], precision)), lo["b"], precision)
        return xn + dx * (_f(p[f"mu_{z}"]) + m)
    r = mm(lerp("r"), p["r"]["kernel"], precision)
    k = mm(lerp("k"), p["k"]["kernel"], precision)
    v = mm(lerp("v"), p["v"]["kernel"], precision)
    g = F.silu(mm(lerp("g"), p["g"]["kernel"], precision))
    lo = p["lora_w"]
    w = torch.exp(-torch.exp(_f(p["w0"]) + mm(
        torch.tanh(mm(lerp("w"), lo["a"], precision)), lo["b"], precision)))
    y = _wkv(r, k, v, w, _f(p["u"]), dh)
    B, T, d = y.shape
    y = layer_norm(y.view(B, T, d // dh, dh), eps=eps_gn).view(B, T, d)
    y = y * _f(p["gn"]) + _f(p["gn_b"])
    return mm(y * g, p["o"]["kernel"], precision)


def _channel_mix(p, x, precision):
    xn = layer_norm(x, p["ln"], p["ln_b"])
    dx = _shift(xn) - xn
    xk = xn + dx * _f(p["mu_k"])
    xr = xn + dx * _f(p["mu_r"])
    k = torch.square(torch.relu(mm(xk, p["k"]["kernel"], precision)))
    return (torch.sigmoid(mm(xr, p["r"]["kernel"], precision))
            * mm(k, p["v"]["kernel"], precision))


def logits(weights: dict, model: dict, seqs: list, positions: list, *,
           precision: str = "float32", device=None) -> list:
    """Float32 logits (len(positions[i]), V) of each token sequence
    ``seqs[i]`` at its ``positions[i]``, from the recurrence over the
    whole sequence from a zero state."""
    device = device or weights["embed"].device
    d, ff = model["d_model"], model["d_ff"]
    out: list = [None] * len(seqs)

    def cost(rows, T):
        return rows * T * max(ff, 4 * d)

    with torch.inference_mode(), exact_float32():
        head = weights["head"].float()
        for idx in blocks(seqs, BLOCK_ELEMENTS, cost):
            tok = padded(seqs, idx, device)
            x = layer_norm(weights["embed"][tok].float(), weights["ln_in"],
                           weights["ln_in_b"])
            for p in weights["layers"]:
                x = x + _time_mix(p["att"], x, model, precision)
                x = x + _channel_mix(p["ffn"], x, precision)
            x = layer_norm(x, weights["ln_out"], weights["ln_out_b"])
            for r, i in enumerate(idx):
                pos = torch.as_tensor(positions[i], device=device)
                out[i] = mm(x[r, pos], head, precision)
    return out
