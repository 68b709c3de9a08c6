"""Model FLOPs of a served request of RWKV-6: matrix products at 2
FLOPs a multiply-add (r, k, v, g, o, the five token-shift LoRAs,
channel mix), the recurrence at 7 operations a state element a token
(as ``wkv6_decode_bound``).  A prefill computes the logits of its last
position only; a decode step those of its one token."""


def request_flops(model: dict, S: int, n: int) -> float:
    """FLOPs of a request of ``S`` prompt tokens that serves ``n``
    tokens: S tokens of prefill and n - 1 decode steps."""
    d, ff, L = model["d_model"], model["d_ff"], model["n_layers"]
    r = model["lora_rank"]
    per_token = L * (2 * (5 * d * d + 5 * 2 * d * r + 2 * d * ff + d * d)
                     + 7 * d * model["rwkv_head_dim"])
    logits = 2 * d * model["vocab_size"]
    return float((S + n - 1) * per_token + n * logits)
