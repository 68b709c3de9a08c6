"""Shared helpers of the benchmark's tests: a benchmark object with the
smoke cells (CPU rehearsal) beside the real ones, and the ``cuda``
fixture of the tests that need the card."""

import copy
import json
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
#: smoke cell -> the full-size cell whose limits it is held to
SMOKE_CELLS = {
    "olmo-smoke.decode-smoke": ("olmo-smoke", "decode-smoke",
                                "olmo-1b.decode-failstop"),
    "rwkv6-smoke.decode-smoke": ("rwkv6-smoke", "decode-smoke",
                                 "rwkv6-1.6b.prefill-failstop"),
    "olmo-smoke.prefill-smoke": ("olmo-smoke", "prefill-smoke",
                                 "olmo-1b.prefill-failstop"),
    "rwkv6-smoke.prefill-smoke": ("rwkv6-smoke", "prefill-smoke",
                                  "rwkv6-1.6b.prefill-failstop"),
}


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def smoke_benchmark() -> dict:
    """BENCHMARK.json with each smoke cell reporting what its full-size
    cell reports."""
    bench = copy.deepcopy(benchmark())
    for name, (config, mix, full) in SMOKE_CELLS.items():
        bench["workloads"].append(dict(name=name, config=config,
                                       traffic=mix, chips=1))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and full in m["workloads"]:
                m["workloads"].append(name)
    return bench


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
