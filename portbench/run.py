#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card this process sees.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Set-up (import, loading or building the
kernel library, drawing the weights from the seed on the card, one
warm-up loop of the cell's own sizes) is timed from the process's start
to the first measured loop; ``readings.build_s`` in the result says how
much of it built the kernel library (non-zero only in a checkout's
first run).  Then whole closed loops start while fewer than
``--seconds`` have passed, and the window ends with the last one;
with ``--trace 1`` the engine's flight recorder is on and the window's
first loop runs under ``torch.profiler``.  After the window: the peak
device memory, the metrics (``--trace 0``: the cell's end-to-end ones;
``--trace 1``: its per-layer ones), the check of the commits and of a
sample of served tokens against the float32 reference.

The last line of standard output is one JSON object with ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (``breakdown`` when
traced) and, last, ``checks``: each number compared with its limit,
also printed as the last lines of standard error.  Exits 2 without a
card (or fewer than the cell asks for), 3 when ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` was imported, printing no result.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

#: tokens each request of the warm-up loop serves
WARM_NEW = 2
#: metric sources a run on the CPU leaves out: timings and device reads
#: of a CPU run say nothing about the card
CPU_SILENT = ("host_clock", "device_trace")


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of ``workload`` reports."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]]


def power_limit() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def execute(bench: dict, workload: str, *, seed: int, seconds: float,
            trace: bool, device: str = "cuda", fault=None,
            limits: str | None = None, forbid=None, log=print) -> dict:
    """One run of ``workload`` -> the result object (see the module).
    ``limits`` names another cell's limits file; ``forbid`` the
    top-level modules that may not be loaded once the window has closed
    (default ``harness.FORBIDDEN``); ``fault`` breaks the timed path
    (``harness.FAULTS``, the tests)."""
    import torch

    from portbench import harness
    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    cell = harness.Cell(wl["config"], wl["traffic"], limits or workload)
    entries = cell_metrics(bench, workload, trace)
    on_card = torch.device(device).type == "cuda"
    if not on_card:
        entries = [m for m in entries if m["source"] not in CPU_SILENT]
    build_s = 0.0
    if on_card:
        from repro_torch.kernels import _build
        _build.library()
        build_s = float(_build.build_seconds)
        log(f"kernels: library loaded ({build_s:.1f} s of build)")
    runner = harness.Runner(cell, seed, device, trace=trace, fault=fault)
    log(f"weights drawn at {time.perf_counter() - T_IMPORT:.1f} s")
    # warm-up: a loop of the same sizes, two tokens a request: every
    # prompt length's prefill and a decode step (no kernel compiles in
    # this eager program; the warm-up loads each kernel and sizes each
    # product once)
    runner.loop(0, cap_new=WARM_NEW)
    log(f"warm-up done at {time.perf_counter() - T_IMPORT:.1f} s")
    if trace and on_card:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(8, device=device).sum().item()
    if on_card:
        torch.cuda.synchronize()
    from repro_torch.kernels import dispatch
    dispatch.reset_launches()
    age = harness.process_age_s()
    setup_s = age if age is not None else time.perf_counter() - T_IMPORT
    loops, t0, t1 = harness.window(runner, seconds)
    peak = 0
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    bad = harness.forbidden_modules(
        harness.FORBIDDEN if forbid is None else forbid)
    if bad:
        raise SystemExit(f"portbench: the run imported {', '.join(bad)}")
    rec = harness.record(cell, loops, t0, t1, setup_s)
    metrics = harness.compute_metrics(
        [m["name"] for m in entries], rec,
        {m["name"]: m["unit"] for m in entries})
    log(f"window closed at {time.perf_counter() - T_IMPORT:.1f} s, "
        f"{len(loops)} loops")
    judged = harness.judge_run(runner, loops)
    log(f"checked at {time.perf_counter() - T_IMPORT:.1f} s")
    checks = judged["checks"]
    if on_card:
        checks["sites_off_card"] = harness.sites_check(cell, loops)
    attempted = sum(lp["n_requests"] for lp in rec["loops"])
    failed = sum(lp["n_requests"] - lp["n_committed"] for lp in rec["loops"])
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(0) if on_card else "cpu",
               count=1, memory_peak_bytes=int(peak))
    result = dict(correct=harness.passed(checks), attempted=attempted,
                  failed=failed, metrics=metrics, device=dev)
    tr = rec["trace"]
    if trace and on_card and tr is not None:
        dev.update(busy_s=tr["busy_s"], window_s=tr["span_s"])
        result["breakdown"] = dict(device_ops=tr["device_ops"],
                                   idle_gaps=tr["idle_gaps"])
    # the first run in a checkout builds the kernel library inside its
    # set-up: its seconds, so that such a run reads apart
    result["readings"] = dict(judged["readings"], build_s=build_s)
    result["loops"] = len(loops)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_benchmark()
    wl = next((w for w in bench["workloads"]
               if w["name"] == args.workload), None)
    if wl is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < wl["chips"]):
        print(f"portbench: {args.workload} needs {wl['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(msg):
        print(f"portbench: {msg}", file=sys.stderr, flush=True)
    log(f"card: {power_limit()}")
    try:
        result = execute(bench, args.workload, seed=args.seed,
                         seconds=args.seconds, trace=bool(args.trace),
                         log=log)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
