"""Requests committed in the window, over the window's seconds (the
window is whole loops: it ends when its last loop does)."""


def compute(record):
    n = len(record["commits"])
    return n / record["window_s"] if n else None
