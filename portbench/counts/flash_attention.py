"""flash_attention (``csrc/flash_attention.cu``, the wgmma variant for
bf16): causal attention of a prompt's prefill, on the tensor cores.
``attention_ops`` and the bytes are frozen from ``chip_smoke.py``
(``attention_shape``), generalised from B = 1 to B rows."""

from portbench.counts.peaks import PEAK_BF16, bound_ms

SITE = "flash_attention"


def attention_ops(B: int, H: int, S: int, D: int, Dv: int,
                  causal: bool) -> float:
    """Matrix-product FLOPs of attention over the (query, key) pairs it
    computes: 2 D for the score, 2 Dv for P V."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return B * H * pairs * (2 * D + 2 * Dv)


def launch_bytes(B: int, S: int, H: int, KV: int, D: int, Dv: int,
                 size: int = 2) -> float:
    """q, k, v read and the output written in ``size``-byte elements,
    the float32 log-sum-exp written."""
    return B * (size * (S * H * D + S * KV * D + S * KV * Dv + S * H * Dv)
                + 4 * H * S)


def group_bound_s(model: dict, group: dict) -> float:
    """Least seconds of the group's prefill launches (one a layer),
    counted over its real rows."""
    H, KV = model["n_heads"], model["n_kv_heads"]
    D = model.get("d_head") or model["d_model"] // H
    B, S = group["rows"], group["S"]
    ms, _ = bound_ms(launch_bytes(B, S, H, KV, D, D),
                     attention_ops(B, H, S, D, D, True), PEAK_BF16)
    return model["n_layers"] * ms / 1e3
