"""Model FLOPs of a served request of DeepSeek-V2 (MLA + dropless MoE):
matrix products at 2 FLOPs a multiply-add over the active parameters
only (the top-k routed and the shared experts of a token, the router),
MLA at its own dims, the logits of the last position.  A prefill takes
the decompressed form (k_nope and v expanded for every token, attention
at D = nope + rope and Dv = v); a decode step the absorbed one (the
query and the output through W_uk and W_uv, attention over the
compressed cache: c + rope for the score, c for the context).

Loading this module refuses a program whose ``ModelConfig`` lacks the
fields that select the published routing and YaRN: such a program would
drop them without a word and serve another model than the one counted
here and held to the reference."""

import dataclasses

from repro_torch.models.config import ModelConfig

#: the configuration's fields a program must know to serve it as stated
PUBLISHED_FIELDS = ("moe_dropless", "norm_topk_prob", "routed_scaling_factor",
                    "rope_scaling")
_missing = sorted(set(PUBLISHED_FIELDS)
                  - {f.name for f in dataclasses.fields(ModelConfig)})
if _missing:
    raise SystemExit(f"portbench: the program's ModelConfig lacks "
                     f"{', '.join(_missing)}: it cannot serve DeepSeek-V2 "
                     f"as its configuration states")


def _dims(model: dict):
    return (model["d_model"], model["n_heads"], model["kv_lora_rank"],
            model["nope_head_dim"], model["rope_head_dim"],
            model["v_head_dim"])


def _ffn_params(model: dict) -> int:
    """Active feed-forward parameters of a token over every layer."""
    d, f = model["d_model"], model["d_expert"]
    n_dense = model["n_dense_layers"]
    n_moe = model["n_layers"] - n_dense
    moe = (d * model["n_routed_experts"]
           + (model["top_k"] + model["n_shared_experts"]) * 3 * d * f)
    return n_dense * 3 * d * model["d_ff"] + n_moe * moe


def request_flops(model: dict, S: int, n: int) -> float:
    """FLOPs of a request of ``S`` prompt tokens that serves ``n``
    tokens: the prefill, then n - 1 decode steps at contexts S + 1 ..
    S + n - 1."""
    d, H, c, dn, dr, dv = _dims(model)
    L, V = model["n_layers"], model["vocab_size"]
    proj = d * H * (dn + dr) + d * (c + dr) + H * dv * d     # q, dkv, o
    ffn = _ffn_params(model)
    logits = 2 * d * V
    # W_uk and W_uv: expanding c per token (prefill) and absorbing them
    # into the query and the output (decode) cost the same c H (dn + dv)
    per_token = 2 * (L * (proj + c * H * (dn + dv)) + ffn)
    pairs = S * (S + 1) // 2
    prefill = S * per_token + L * H * pairs * 2 * (dn + dr + dv) + logits
    decode = sum(per_token + L * H * (S + i) * 2 * (2 * c + dr) + logits
                 for i in range(1, n))
    return float(prefill + decode)
