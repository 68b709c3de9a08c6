"""A CPU rehearsal of ``run.py`` at the smoke configs, and its faults.

The rehearsal skips the look for a card and drives the rest of a run:
set-up, a warm-up loop, a short window of closed loops under the
fail-stop, the record, the metrics a CPU run may name (counts and
engine spans, no timing and no device reading), the commit check and
the served tokens against the float32 reference, and the last line.
With the timed path broken underneath (a served token altered where it
is produced; a decode step that returns its state unchanged) the same
run must come out not correct."""

import json
import os
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests.conftest import ROOT, SMOKE_CELLS, smoke_benchmark

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
REHEARSE = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
from portbench import run
from portbench.tests.conftest import SMOKE_CELLS, smoke_benchmark
bench = smoke_benchmark()
for cell, trace in {cells!r}:
    r = run.execute(bench, cell, seed=2**33 + 7, seconds=0.3, trace=trace,
                    device="cpu", limits=SMOKE_CELLS[cell][2], log=lambda m: 0)
    print(json.dumps(r))
"""


def cpu_silent(bench):
    return {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
            if m["source"] in run.CPU_SILENT}


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "olmo-1b.decode-failstop", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr


def test_rehearsal_in_a_fresh_process():
    """Both families, both mixes, one traced; the process loads no
    module of jax or the JAX package (``execute`` refuses otherwise)."""
    cells = [("olmo-smoke.decode-smoke", False),
             ("rwkv6-smoke.prefill-smoke", True),
             ("olmo-smoke.prefill-smoke", False),
             ("rwkv6-smoke.decode-smoke", False)]
    code = REHEARSE.format(src=str(ROOT / "src"), root=str(ROOT),
                           cells=cells)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()[-len(cells):]
    bench = smoke_benchmark()
    for (cell, trace), line in zip(cells, lines):
        r = json.loads(line)
        assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
        assert r["correct"] is True, r["checks"]
        mix = SMOKE_CELLS[cell][1]
        loop = json.load(open(ROOT / "portbench" / "traffic"
                              / f"{mix}.json"))["loop_requests"]
        assert r["attempted"] == loop * r["loops"] and r["failed"] == 0
        assert r["device"]["platform"] == "cpu"
        assert "breakdown" not in r
        names = set(r["metrics"])
        assert not names & cpu_silent(bench)
        want = {m["name"] for m in run.cell_metrics(bench, cell, trace)
                if m["source"] not in run.CPU_SILENT}
        assert names == want and (names or not trace)
        assert r["readings"]["served_tokens"] >= 1
        checks = r["checks"]
        assert checks["max_gap"]["value"] <= checks["max_gap"]["limit"]
        assert all(checks[k]["value"] == 0 for k in (
            "uncommitted", "commits_not_once", "not_first_completion",
            "hung_loops"))


@pytest.mark.parametrize("fault", ["token", "state"])
@pytest.mark.parametrize("cell", ["olmo-smoke.decode-smoke",
                                  "rwkv6-smoke.decode-smoke"])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    r = run.execute(smoke_benchmark(), cell, seed=11, seconds=0.2,
                    trace=False, device="cpu", fault=fault,
                    limits=SMOKE_CELLS[cell][2], forbid=(),
                    log=lambda m: None)
    assert r["correct"] is False
    gap = r["checks"]["max_gap"]
    assert gap["value"] > gap["limit"]
