"""moe_gemm (``kernels/moe.py``, two launches a MoE layer: gate-up and
down): the routed experts' products of a layer, bf16 on the tensor
cores.  The least it needs: the weights of every expert some token was
routed to read once (at most E, at most tokens x k), the layer's input
rows read and its output rows written in bf16, against 2 x 3 x d x f
FLOPs a routed row."""

from portbench.counts.peaks import PEAK_BF16, bound_ms

SITE = "moe_gemm"


def layer_bytes(tokens: int, d: int, f: int, n_experts: int,
                top_k: int) -> float:
    touched = min(n_experts, tokens * top_k)
    return touched * 3 * d * f * 2 + 2 * tokens * d * 2


def layer_ops(tokens: int, d: int, f: int, top_k: int) -> float:
    return 2 * 3 * d * f * tokens * top_k


def group_bound_s(model: dict, group: dict) -> float:
    """Least seconds of the group's launches over its real rows: the
    prefill's rows x S tokens, then n - 1 decode steps of rows tokens,
    in each MoE layer."""
    d, f = model["d_model"], model["d_expert"]
    E, K = model["n_routed_experts"], model["top_k"]
    n_moe = model["n_layers"] - model["n_dense_layers"]
    rows, S, n = group["rows"], group["S"], group["n"]
    total = 0.0
    for tokens, times in ((rows * S, 1), (rows, n - 1)):
        if times:
            ms, _ = bound_ms(layer_bytes(tokens, d, f, E, K),
                             layer_ops(tokens, d, f, K), PEAK_BF16)
            total += times * ms
    return n_moe * total / 1e3
