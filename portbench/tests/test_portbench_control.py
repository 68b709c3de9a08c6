"""The precision control of the output comparison: the reference put in
the program's place one precision below the served bfloat16 (float8
e4m3 operands of every matrix product) must come out not correct.

On the card (marked ``cuda``), at each cell's own size and load, three
seeds: the program's widest gap is within the cell's limit and the
control's is above it.  On the CPU, at the smoke configs: the control
departs further from float32 than the served program does."""

import json

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT, SMOKE_CELLS, benchmark

CONTROL_SEEDS = (2**31 + 101, 2**32 + 202, 2**33 + 303)


def readings(config, mix, limits, seed, device, seconds):
    cell = harness.Cell(config, mix, limits)
    runner = harness.Runner(cell, seed, device)
    loops, _, _ = harness.window(runner, seconds)
    return harness.judge_run(runner, loops, controls=("fp8",))


@pytest.mark.parametrize("cell", ["olmo-smoke.decode-smoke",
                                  "rwkv6-smoke.decode-smoke"])
def test_control_departs_further_than_the_program(cell):
    config, mix, full = SMOKE_CELLS[cell]
    for seed in CONTROL_SEEDS[:2]:
        j = readings(config, mix, full, seed, "cpu", 0.2)
        prog = j["checks"]["max_gap"]["value"]
        ctrl = j["readings"]["control_fp8_max_gap"]
        assert ctrl > prog and ctrl > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  benchmark()["workloads"]])
def test_control_fails_the_cell_on_the_card(cuda, cell):
    wl = next(w for w in benchmark()["workloads"] if w["name"] == cell)
    limit = json.load(open(ROOT / "portbench" / "limits"
                           / f"{cell}.json"))["max_gap"]
    for seed in CONTROL_SEEDS:
        j = readings(wl["config"], wl["traffic"], cell, seed, cuda, 4.0)
        assert j["checks"]["max_gap"]["value"] <= limit
        assert j["readings"]["control_fp8_max_gap"] > limit
