"""The most rows routed to one (layer, expert) over the mean of the
MoE layers' (layer, expert) cells, from the program's device counter
``kernels.moe.ROWS_COUNTER`` (zeroed with the launch counts before the
window, read after it).  None where the program keeps no such counter."""

from repro_torch.kernels import dispatch

COUNTER = "moe_expert_rows"


def compute(record):
    read = getattr(dispatch, "device_counters", None)
    rows = read().get(COUNTER) if read is not None else None
    if rows is None:
        return None
    rows = rows.double().cpu()
    rows = rows[rows.sum(dim=1) > 0]        # the MoE layers
    if rows.numel() == 0:
        return None
    return float(rows.max() / rows.mean())
