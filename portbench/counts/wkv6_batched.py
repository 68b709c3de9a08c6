"""wkv6_batched (``csrc/wkv6.cu``): the RWKV-6 recurrence over a
prompt, in chunks.  ``wkv6_batched_ops`` and ``wkv6_batched_bound`` are
frozen from ``chip_smoke.py``."""

from portbench.counts.peaks import bound_ms

SITE = "wkv6_batched"
CHUNK = 32


def wkv6_batched_ops(BH: int, T: int, dk: int, dv: int,
                     chunk: int) -> float:
    """FP32 operations of the chunked form (csrc/wkv6.cu) over T steps:
    per chunk of c rows, the log and cumulative sum (2 c dk), the pairwise
    scores (c(c-1)/2 dk x 5: sub, exp, two muls, add), the u bonus
    (3 c dk), r and k under decay (5 c dk), y (c(c+1) dv + 2 c dk dv) and
    the carried state (dk dv (2 c + 1))."""
    ops = 0
    for t0 in range(0, T, chunk):
        c = min(chunk, T - t0)
        ops += (2 * c * dk + c * (c - 1) // 2 * dk * 5 + 3 * c * dk
                + 5 * c * dk + c * (c + 1) * dv + 2 * c * dk * dv
                + dk * dv * (2 * c + 1))
    return BH * ops


def wkv6_batched_bound(BH: int, T: int, dk: int, dv: int,
                       chunk: int) -> tuple[float, str]:
    """bf16 r, k, w (T dk), v (T dv) and u read, y (float32) written, the
    float32 state read and written."""
    n_bytes = (2 * (3 * BH * T * dk + BH * T * dv + BH * dk)
               + 4 * BH * T * dv + 8 * BH * dk * dv)
    return bound_ms(n_bytes, wkv6_batched_ops(BH, T, dk, dv, chunk))


def group_bound_s(model: dict, group: dict) -> float:
    """Least seconds of the group's prefill launches (one a layer over
    its S prompt tokens), over its real rows."""
    dh = model["rwkv_head_dim"]
    BH = group["rows"] * (model["d_model"] // dh)
    ms, _ = wkv6_batched_bound(BH, group["S"], dh, dh, CHUNK)
    return model["n_layers"] * ms / 1e3
