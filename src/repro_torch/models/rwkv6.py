"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free LM with data-dependent
decay.  Assigned arch: rwkv6-1.6b (24L, d=2048, d_ff=7168, vocab=65536).

Port of ``repro.models.rwkv6``.  Time-mix block (per head, head dim 64):
    ddlerp token shift:  x_z = x + (x_prev - x) * (mu_z + lora_z(x_mix))
    r,k,v,g projections; decay  w_t = exp(-exp(w0 + lora_w(x_mix)))
    wkv recurrence:      y_t = (S_t + diag(u) k_t v_t^T)^T r_t
                         S_{t+1} = diag(w_t) S_t + k_t v_t^T
    GroupNorm per head, gate by silu(g), output projection.
Channel-mix block:  k = relu(W_k x_k)^2 ; out = sigmoid(W_r x_r) * (W_v k).

The recurrence runs through ``kernels.wkv6_decode`` for one token and
``kernels.wkv6_batched`` (chunk 32, ragged last chunk) for more: the CUDA
kernels on the card, their plain versions on the CPU.  The carried state
(token shifts and per-head wkv state) IS the decode cache; it is
preallocated and updated in place.

Because that state is O(1), a prefill may run as a chain of fixed-length
segments, each on the state the last one left
(:attr:`RWKV6Model.prefill_segmentable`).  A state that carries
``"valid"``, a 0-dim int32 device count of the segment's real tokens,
pads the rest: there ``k = 0`` and ``w = 1``, so the wkv state passes
unchanged (``S = 1 * S + 0``), and the token shifts and the logits are
read at position ``valid - 1`` through a device index.

Training (:meth:`RWKV6Model.loss`) has a forward of its own: it starts
from a zero state, writes nothing in place, and runs the recurrence
through ``kernels.wkv6_batched_train`` (the same kernel, with a
gradient); every layer is rematerialised under ``nothing_saveable``, as
the reference's forward always is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_scan import CHUNK, wkv6_plain
from repro_torch.models.common import (ParamSpec, ParamTree, dense,
                                       dense_specs, init_params, layer_norm,
                                       remat, softmax_xent)
from repro_torch.models.config import ModelConfig

LORA_RANK = 32


# ------------------------------------------------------------- wkv (plain)
def wkv6_sequential(r, k, v, w, u, state):
    """Reference recurrence, one step at a time.  r,k,w: (T, dk);
    v: (T, dv); u: (dk,); state: (dk, dv).  Returns (y (T, dv), state)."""
    S = state
    ys = []
    for t in range(r.shape[0]):
        kv = k[t][:, None] * v[t][None, :]
        ys.append(((S + u[:, None] * kv) * r[t][:, None]).sum(0))
        S = w[t][:, None] * S + kv
    return torch.stack(ys), S


def wkv6_chunked(r, k, v, w, u, state, *, chunk: int = CHUNK):
    """Chunked form, float32 accumulators, any T (the last chunk may be
    shorter).  Within a chunk each pair of steps carries its own decay
    (``kernels.rwkv6_scan``), which cannot overflow, where the reference
    scales k by exp(-cumsum log w).  Returns (y (T, dv) in r's dtype,
    final state float32)."""
    return wkv6_plain(r, k, v, w, u, state, chunk=chunk)


# ------------------------------------------------------------------ specs
def _lora_spec(d: int, out: int, dt) -> dict:
    return {"a": ParamSpec((d, LORA_RANK), dtype=dt),
            "b": ParamSpec((LORA_RANK, out), dtype=dt, init="zeros")}


def _lora(p, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ p["a"]) @ p["b"]


def time_mix_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    dt = cfg.param_dtype
    s = {
        "mu_base": ParamSpec((d,), init="zeros", dtype=dt),
        "ln": ParamSpec((d,), init="ones", dtype=dt),
        "ln_b": ParamSpec((d,), init="zeros", dtype=dt),
        "gn": ParamSpec((d,), init="ones", dtype=dt),
        "gn_b": ParamSpec((d,), init="zeros", dtype=dt),
        "w0": ParamSpec((d,), init="zeros", dtype=dt),
        "u": ParamSpec((d,), init="zeros", dtype=dt),
        "o": dense_specs(d, d, dtype=dt),
    }
    for z in ("r", "k", "v", "g", "w"):
        s[f"mu_{z}"] = ParamSpec((d,), init="zeros", dtype=dt)
        s[f"lora_{z}"] = _lora_spec(d, d, dt)
    for z in ("r", "k", "v", "g"):
        s[z] = dense_specs(d, d, dtype=dt)
    return s


def channel_mix_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    return {
        "ln": ParamSpec((d,), init="ones", dtype=dt),
        "ln_b": ParamSpec((d,), init="zeros", dtype=dt),
        "mu_k": ParamSpec((d,), init="zeros", dtype=dt),
        "mu_r": ParamSpec((d,), init="zeros", dtype=dt),
        "k": dense_specs(d, f, dtype=dt),
        "v": dense_specs(f, d, dtype=dt),
        "r": dense_specs(d, d, dtype=dt),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: returns x_{t-1}; prev = last token of the previous
    segment (B, D) (zeros at stream start)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def real_positions(valid: torch.Tensor, S: int) -> tuple:
    """A padded segment of S positions whose first ``valid`` (a 0-dim
    device count) are real -> (which positions are real, (1, S, 1) bool;
    the last real one, a (1,) int64 index), both on the device."""
    pos = torch.arange(S, device=valid.device)
    return (pos < valid).view(1, S, 1), (valid.long() - 1).view(1)


def _last(x: torch.Tensor, real) -> torch.Tensor:
    """x's last position (B, D), or its last real one in a padded
    segment (``real`` of :func:`real_positions`)."""
    return x[:, -1, :] if real is None else x.index_select(1, real[1])[:, 0]


def _ddlerp(p, x, dx, x_mix, z: str):
    """Data-dependent lerp toward the previous token for projection z;
    dx = x_prev - x and x_mix = x + dx * mu_base are shared by the five
    projections (the reference recomputes them for each)."""
    return x + dx * (p[f"mu_{z}"] + _lora(p[f"lora_{z}"], x_mix))


def time_mix(p, cfg: ModelConfig, x, prev_tok, wkv_state, real=None):
    """x: (B,S,D); prev_tok: (B,D); wkv_state: (B,H,dk,dv) float32,
    updated in place, or None for training: the recurrence then starts
    from a zero state under autograd (``wkv6_batched_train``) and writes
    nothing in place.  ``real`` (:func:`real_positions`) pads a segment:
    k = 0 and w = 1 past its real positions.  Returns (out, last (real)
    normed token, wkv_state)."""
    B, S, D = x.shape
    dh = cfg.rwkv_head_dim
    H = D // dh
    xn = layer_norm(x, p["ln"], p["ln_b"])
    dx = _shift(xn, prev_tok) - xn
    x_mix = xn + dx * p["mu_base"]
    r = dense(p["r"], _ddlerp(p, xn, dx, x_mix, "r"))
    k = dense(p["k"], _ddlerp(p, xn, dx, x_mix, "k"))
    v = dense(p["v"], _ddlerp(p, xn, dx, x_mix, "v"))
    g = F.silu(dense(p["g"], _ddlerp(p, xn, dx, x_mix, "g")))
    w_log = p["w0"] + _lora(p["lora_w"], _ddlerp(p, xn, dx, x_mix, "w"))
    w = torch.exp(-torch.exp(w_log.float())).to(x.dtype)
    if real is not None:          # padding leaves the wkv state as it was
        k = torch.where(real[0], k, 0.0)
        w = torch.where(real[0], w, 1.0)

    def fold(t):                              # (B,S,D) -> (B*H, S, dh)
        return t.reshape(B, S, H, dh).transpose(1, 2).reshape(B * H, S, dh)

    uu = p["u"].reshape(1, H, dh).expand(B, H, dh).reshape(B * H, dh)
    ss = None if wkv_state is None else wkv_state.view(B * H, dh, dh)
    if ss is None:
        zero = torch.zeros((B * H, dh, dh), dtype=torch.float32,
                           device=x.device)
        y, _ = ops.wkv6_batched_train(
            *(fold(t).contiguous() for t in (r, k, v, w)), uu.contiguous(),
            zero, chunk=CHUNK)
    elif S == 1:
        y, _ = ops.wkv6_decode(*(fold(t)[:, 0].contiguous()
                                 for t in (r, k, v, w)),
                               uu.contiguous(), ss, out_state=ss)
    else:
        y, _ = ops.wkv6_batched(*(fold(t).contiguous() for t in (r, k, v, w)),
                                uu.contiguous(), ss, chunk=CHUNK,
                                out_state=ss)
    y = y.reshape(B, H, S, dh).to(x.dtype).transpose(1, 2)   # (B,S,H,dh)
    y = layer_norm(y, None, None).reshape(B, S, D)           # per-head GN
    y = y * p["gn"] + p["gn_b"]
    out = dense(p["o"], (y * g).to(x.dtype))
    return out, _last(xn, real), wkv_state


def channel_mix(p, cfg: ModelConfig, x, prev_tok, real=None):
    xn = layer_norm(x, p["ln"], p["ln_b"])
    xp = _shift(xn, prev_tok)
    dx = xp - xn
    xk = xn + dx * p["mu_k"]
    xr = xn + dx * p["mu_r"]
    k = torch.square(F.relu(dense(p["k"], xk)))
    out = torch.sigmoid(dense(p["r"], xr)) * dense(p["v"], k)
    return out, _last(xn, real)


# ------------------------------------------------------------------ model
class RWKV6Model:
    #: a prefill may run as a chain of fixed-length segments, each on the
    #: state the last one left, the last padded (a state carrying
    #: ``"valid"``): the decode cache is an O(1) carried state
    prefill_segmentable = True

    def __init__(self, cfg: ModelConfig):
        if cfg.d_model % cfg.rwkv_head_dim:
            raise ValueError(f"d_model {cfg.d_model} is not a multiple of "
                             f"rwkv_head_dim {cfg.rwkv_head_dim}")
        self.cfg = cfg
        self.n_heads_rwkv = cfg.d_model // cfg.rwkv_head_dim

    def param_specs(self) -> dict:
        cfg = self.cfg
        dt = cfg.param_dtype
        d = cfg.d_model
        return {
            "embed": ParamSpec((cfg.vocab_size, d), init="embed", dtype=dt),
            "ln_in": ParamSpec((d,), init="ones", dtype=dt),
            "ln_in_b": ParamSpec((d,), init="zeros", dtype=dt),
            "layers": [{"att": time_mix_specs(cfg),
                        "ffn": channel_mix_specs(cfg)}
                       for _ in range(cfg.n_layers)],
            "ln_out": ParamSpec((d,), init="ones", dtype=dt),
            "ln_out_b": ParamSpec((d,), init="zeros", dtype=dt),
            "head": ParamSpec((d, cfg.vocab_size), dtype=dt),
        }

    def init(self, seed: int = 0, *, device=None) -> ParamTree:
        """Random weights from a ``torch.Generator`` seeded with ``seed``,
        drawn on ``device`` (None: the card; raises without one)."""
        return init_params(self.param_specs(), seed=seed,
                           device=resolve(device))

    # ---------------------------------------------------------- state
    def init_state(self, batch: int, *, device=None) -> dict:
        cfg = self.cfg
        dev = resolve(device)
        H, dh = self.n_heads_rwkv, cfg.rwkv_head_dim
        tok = (cfg.n_layers, batch, cfg.d_model)
        return {
            "att_tok": torch.zeros(tok, dtype=cfg.param_dtype, device=dev),
            "ffn_tok": torch.zeros(tok, dtype=cfg.param_dtype, device=dev),
            "wkv": torch.zeros((cfg.n_layers, batch, H, dh, dh),
                               dtype=torch.float32, device=dev),
        }

    def init_cache(self, batch: int, max_len: int, *, device=None) -> dict:
        return self.init_state(batch, device=device)  # O(1) state

    # -------------------------------------------------------- forward
    def loss(self, params, batch: dict):
        """batch: tokens (B, S), labels (B, S) and an optional mask, as
        tensors on the params' device -> (loss, {}), the reference's:
        the next-token cross-entropy of the training forward."""
        logits = self._train_forward(params, batch["tokens"])
        return softmax_xent(logits, batch["labels"], batch.get("mask")), {}

    def _train_layer(self, lp, x: torch.Tensor) -> torch.Tensor:
        zero = x.new_zeros((x.shape[0], x.shape[-1]))
        x = x + time_mix(lp["att"], self.cfg, x, zero, None)[0]
        return x + channel_mix(lp["ffn"], self.cfg, x, zero)[0]

    def _train_forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V) from a zero state, nothing
        written in place, each layer rematerialised under
        ``nothing_saveable`` (the reference's ``jax.checkpoint``)."""
        x = F.embedding(tokens, params["embed"])
        x = layer_norm(x, params["ln_in"], params["ln_in_b"])
        layer = remat(self._train_layer, "nothing_saveable")
        for lp in params["layers"]:
            x = layer(lp, x)
        x = layer_norm(x, params["ln_out"], params["ln_out_b"])
        return x @ params["head"]

    def forward(self, params, tokens: torch.Tensor, state=None, *,
                last_only: bool = False):
        """tokens: (B, S) -> (logits (B, S, V), state).  ``state`` (a
        fresh one when None) is carried through and updated in place; one
        carrying ``"valid"`` pads the positions from ``valid`` on (see the
        module), and ``last_only`` then reads the last real one."""
        cfg = self.cfg
        B, S = tokens.shape
        if state is None:
            state = self.init_state(B, device=tokens.device)
        real = (real_positions(state["valid"], S) if "valid" in state
                else None)
        x = F.embedding(tokens, params["embed"])
        x = layer_norm(x, params["ln_in"], params["ln_in_b"])
        for i, lp in enumerate(params["layers"]):
            y, att_tok, _ = time_mix(lp["att"], cfg, x, state["att_tok"][i],
                                     state["wkv"][i], real)
            state["att_tok"][i] = att_tok
            x = x + y
            y, ffn_tok = channel_mix(lp["ffn"], cfg, x, state["ffn_tok"][i],
                                     real)
            state["ffn_tok"][i] = ffn_tok
            x = x + y
        x = layer_norm(x, params["ln_out"], params["ln_out_b"])
        if last_only:
            x = (x[:, -1:, :] if real is None
                 else x.index_select(1, real[1]))
        return x @ params["head"], state

    # --------------------------------------------------------- decode
    def prefill(self, params, cache: dict, tokens: torch.Tensor):
        """Prompt prefill: one stateful full-sequence pass (the carried
        state IS the decode cache), or one segment of a chain of them
        (a ``cache`` carrying ``"valid"``: the segment's real tokens).
        Returns (last (real) position logits (B, 1, V), state)."""
        return self.forward(params, tokens, cache, last_only=True)

    def decode_step(self, params, cache: dict, tokens: torch.Tensor,
                    pos: int):
        """tokens: (B, 1).  pos unused (stateful recurrence)."""
        logits, state = self.forward(params, tokens, cache)
        return logits[:, -1:], state
