"""moe_gemm's share of its roofline in the profiled loop (``roofline.share``)."""

from portbench.roofline import share


def compute(record):
    return share(record, "moe_gemm")
