"""wkv6_batched's share of its roofline in the profiled loop (``roofline.share``)."""

from portbench.roofline import share


def compute(record):
    return share(record, "wkv6_batched")
