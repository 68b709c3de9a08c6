"""The MoE kernels' device seconds (the config's sites named ``moe_*``:
the routing and the grouped expert products) over the profiled loop's
busy seconds (the union of device intervals), in %."""


def compute(record):
    tr = record["trace"]
    if not tr or not tr["busy_s"]:
        return None
    moe = sum(s for k, s in tr["kernel_s"].items() if k.startswith("moe_"))
    return 100.0 * moe / tr["busy_s"] if moe else None
