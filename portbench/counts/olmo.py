"""Model FLOPs of a served request of a dense decoder (OLMo): matrix
products at 2 FLOPs a multiply-add, attention over the causal context
of each query (2 D for the score, 2 D for P V, as ``attention_ops``).
A prefill computes the logits of its last position only; a decode step
those of its one token."""


def request_flops(model: dict, S: int, n: int) -> float:
    """FLOPs of a request of ``S`` prompt tokens that serves ``n``
    tokens: the prefill, then n - 1 decode steps at contexts S + 1 ..
    S + n - 1."""
    d, H, KV = model["d_model"], model["n_heads"], model["n_kv_heads"]
    D = model.get("d_head") or d // H
    L, V, ff = model["n_layers"], model["vocab_size"], model["d_ff"]
    per_token = 2 * L * (d * H * D + 2 * d * KV * D + H * D * d
                         + 3 * d * ff)
    logits = 2 * d * V
    attn_pair = L * H * 4 * D
    prefill = S * per_token + attn_pair * S * (S + 1) // 2 + logits
    decode = sum(per_token + attn_pair * (S + i) + logits
                 for i in range(1, n))
    return float(prefill + decode)
