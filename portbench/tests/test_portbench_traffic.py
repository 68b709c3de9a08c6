"""The traffic generator: deterministic in the seed, within its bounds,
the same set of sizes for every seed and loop."""

import json
import pathlib

import numpy as np
import pytest

from portbench import traffic

MIXES = sorted(p.stem for p in (pathlib.Path(traffic.__file__).parent
                                / "traffic").glob("*.json"))
SEEDS = (0, 7, 2**31 + 11, 2**33 + 5)


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_loop(mix):
    m = traffic.load(pathlib.Path(traffic.__file__).parent / "traffic"
                     / f"{mix}.json")
    for seed in SEEDS:
        a = traffic.loop(m, seed, 3, 1000)
        b = traffic.loop(m, seed, 3, 1000)
        assert [(p.tolist(), n) for p, n in a] == \
            [(p.tolist(), n) for p, n in b]


@pytest.mark.parametrize("mix", MIXES)
def test_bounds_and_sizes(mix):
    m = traffic.load(pathlib.Path(traffic.__file__).parent / "traffic"
                     / f"{mix}.json")
    sets = set()
    for seed in SEEDS:
        for index in (0, 1, 5):
            reqs = traffic.loop(m, seed, index, 777)
            assert len(reqs) == m["loop_requests"]
            lens = sorted(len(p) for p, _ in reqs)
            news = sorted(n for _, n in reqs)
            pl, nt = m["prompt_len"], m["new_tokens"]
            assert pl["min"] <= lens[0] and lens[-1] <= pl["max"]
            assert nt["min"] <= news[0] and news[-1] <= nt["max"]
            assert all(p.dtype == np.int32 and p.min() >= 0 and p.max() < 777
                       for p, _ in reqs)
            sets.add((tuple(lens), tuple(news)))
    assert len(sets) == 1               # one set of sizes, other orders


def test_seeds_and_loops_shuffle():
    m = traffic.load(pathlib.Path(traffic.__file__).parent / "traffic"
                     / "decode-failstop.json")
    orders = {tuple((len(p), n) for p, n in traffic.loop(m, s, i, 100))
              for s in SEEDS for i in (1, 2)}
    assert len(orders) == 2 * len(SEEDS)


def test_sizes_of_the_mixes():
    """Median and range as the mixes state; uniform counts each whole
    number equally often."""
    u = traffic.sizes({"dist": "uniform", "min": 1, "max": 4}, 64)
    assert np.bincount(u).tolist() == [0, 16, 16, 16, 16]
    ln = traffic.sizes({"dist": "lognormal", "median": 128, "sigma": 0.8,
                        "min": 16, "max": 512}, 32)
    assert ln[15] <= 128 <= ln[16] and ln.min() >= 16 and ln.max() == 512
    assert json.dumps(ln.tolist())
