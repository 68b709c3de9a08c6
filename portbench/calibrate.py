#!/usr/bin/env python3
"""The readings the limits of ``limits/<cell>.json`` are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 4 [--control fp8]

For each seed, in one process: the weights of that seed, a short window
of the cell's own loops (no warm-up: no time is read), then the
comparison a run makes, printing one JSON line with the program's
``max_gap`` and, with ``--control``, the widest gap of the tokens the
reference puts first one precision below the served one.  The lower
reading of a limit is the largest program ``max_gap`` over a dozen
seeds or more; the upper one the smallest control reading."""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE.parent)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control", action="append", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from portbench import harness
    with open(HERE.parent / "BENCHMARK.json") as f:
        bench = json.load(f)
    wl = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cell = harness.Cell(wl["config"], wl["traffic"], wl["name"])
    for seed in (int(s) for s in args.seeds.split(",")):
        runner = harness.Runner(cell, seed, args.device)
        loops, _, _ = harness.window(runner, args.seconds)
        judged = harness.judge_run(runner, loops, controls=args.control)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              loops=len(loops),
                              max_gap=judged["checks"]["max_gap"]["value"],
                              correct=harness.passed(judged["checks"]),
                              **judged["readings"])), flush=True)
        del runner, loops, judged
        gc.collect()
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
