"""flash_decode (``csrc/flash_decode.cu``): one query token of every
(row, head) against the valid slots of its cache, in FP32 on the CUDA
cores.  ``flash_decode_ops`` and the bytes are frozen from
``chip_smoke.py`` (``decode_shape``), generalised from B = 1 to B rows."""

from portbench.counts.peaks import PEAK_FP32, bound_ms

SITE = "flash_decode"


def flash_decode_ops(rows: int, n_valid: int, D: int, Dv: int) -> float:
    return rows * n_valid * (2 * D + 2 * Dv + 4)


def step_bytes(B: int, H: int, KV: int, D: int, n_valid: int,
               L: int) -> float:
    """bf16 q and the valid K/V slots read, the output written, the
    (L,) slot mask read once."""
    return 2 * (B * H * D + 2 * B * KV * n_valid * D + B * H * D) + L


def group_bound_s(model: dict, group: dict) -> float:
    """Least seconds of the group's decode launches: one a layer a step,
    steps i = 1 .. n-1 at n_valid = S + i slots of an L = S + n cache,
    counted over the group's real rows."""
    H, KV = model["n_heads"], model["n_kv_heads"]
    D = model.get("d_head") or model["d_model"] // H
    B, S, n = group["rows"], group["S"], group["n"]
    total = 0.0
    for i in range(1, n):
        ms, _ = bound_ms(step_bytes(B, H, KV, D, S + i, S + n),
                         flash_decode_ops(B * H, S + i, D, D), PEAK_FP32)
        total += ms
    return model["n_layers"] * total / 1e3
