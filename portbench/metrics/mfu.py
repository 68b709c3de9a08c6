"""Model FLOPs of the requests committed in the window (the
family's ``counts`` module: prefill and decode at their own contexts;
duplicates and pad rows not counted), over the window's seconds times
the H100's 989 TFLOP/s bf16 peak, in %."""

from portbench.counts.peaks import PEAK_BF16


def compute(record):
    count = record["flops"].request_flops
    flops = sum(count(record["model"], c["S"], c["n"])
                for c in record["commits"])
    if not flops:
        return None
    return 100.0 * flops / (record["window_s"] * PEAK_BF16)
