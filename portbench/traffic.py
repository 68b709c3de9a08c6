"""The one traffic generator: closed loops of requests, read from a
mix's parameters (``traffic/<name>.json``).

Every loop of every seed serves the same set of sizes: prompt lengths
at the mid-quantiles (i + 1/2) / n of the mix's distribution, new-token
counts spread evenly over their range.  The seed and the loop's number
shuffle which length meets which count, the order the requests are
submitted in, and draw the prompt tokens, so runs with different seeds
do the same work in another order.

Distributions (``prompt_len`` and ``new_tokens``):
  {"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}
  {"dist": "uniform", "min": a, "max": b}      whole numbers a .. b
each rounded to whole tokens and clipped to [min, max].
"""

from __future__ import annotations

import json
import statistics

import numpy as np

#: the stream tag of the correctness sample (loops use 0, 1, 2, ...)
SAMPLE_STREAM = 1 << 40


def load(path) -> dict:
    with open(path) as f:
        return json.load(f)


def sizes(dist: dict, n: int) -> np.ndarray:
    """The n sizes of ``dist`` at its mid-quantiles, ascending."""
    q = (np.arange(n) + 0.5) / n
    if dist["dist"] == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(x) for x in q])
        v = dist["median"] * np.exp(dist["sigma"] * z)
    elif dist["dist"] == "uniform":
        v = dist["min"] + np.floor((dist["max"] - dist["min"] + 1) * q)
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return np.clip(np.rint(v), dist["min"], dist["max"]).astype(np.int64)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), int(stream)])


def loop(mix: dict, seed: int, index: int, vocab: int) -> list:
    """(prompt int32 array, new tokens) of each request of loop
    ``index``, in submission order."""
    n = mix["loop_requests"]
    g = rng(seed, index)
    lens = g.permutation(sizes(mix["prompt_len"], n))
    news = g.permutation(sizes(mix["new_tokens"], n))
    return [(g.integers(0, vocab, size=int(s), dtype=np.int32), int(m))
            for s, m in zip(lens, news)]
