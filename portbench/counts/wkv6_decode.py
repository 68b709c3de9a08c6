"""wkv6_decode (``csrc/wkv6.cu``): one step of the RWKV-6 recurrence
for every (row, head).  ``wkv6_decode_bound`` is frozen from
``chip_smoke.py``."""

from portbench.counts.peaks import bound_ms

SITE = "wkv6_decode"


def wkv6_decode_bound(BH: int, dk: int, dv: int) -> tuple[float, str]:
    """bf16 r, k, w, u and v read, the float32 state read and written, y
    written; 7 operations per state element."""
    n_bytes = 2 * (4 * BH * dk + BH * dv) + 4 * (2 * BH * dk * dv + BH * dv)
    return bound_ms(n_bytes, 7 * BH * dk * dv)


def group_bound_s(model: dict, group: dict) -> float:
    """Least seconds of the group's decode launches: one a layer for
    each of its n - 1 decode steps, over its real rows."""
    dh = model["rwkv_head_dim"]
    BH = group["rows"] * (model["d_model"] // dh)
    ms, _ = wkv6_decode_bound(BH, dh, dh)
    return model["n_layers"] * (group["n"] - 1) * ms / 1e3
