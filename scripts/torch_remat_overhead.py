#!/usr/bin/env python3
"""What layer rematerialisation costs olmo-1b training, and where the host
time goes, on one GPU (bf16, full width and depth, seeded weights).

    python3 scripts/torch_remat_overhead.py [--steps 3] [--workers 4]
        [--variants none,remat,no_rng,lean] [--switch-interval SECONDS]

Variants of the same training run (``chip_smoke.py`` phase 5's: 8 rows
of 2,048 tokens, 8 tasks, ``--workers`` threaded workers, FAC, adamw,
exact accumulation; ``--switch-interval`` sets the interpreter's
``sys.setswitchinterval`` for the whole run):

- ``none``: ``remat_policy`` ``everything_saveable`` (no recompute);
- ``remat``: the config's ``nothing_saveable`` through
  ``models.common.remat`` as it stands;
- ``no_rng``: the same with ``preserve_rng_state=False`` (the models draw
  no random numbers, so nothing needs the RNG state stashed);
- ``lean``: ``preserve_rng_state=False`` and ``determinism_check="none"``.

For each: one task alone, timed and traced; the steps' seconds,
``max_memory_allocated``, each live thread's CPU seconds over the warm steps
(``/proc``: the profiler records only the thread that starts it and the
autograd threads working for it, not the executor's workers) and the
process's, whose rest is the workers' threads that exited, and one
traced step's device busy share (the ``remat_layer`` ranges, which the
profiler also lists on the device, left out).  Every rematerialised layer runs inside
``record_function("remat_layer")``, so the task's trace separates the
recomputation (that range on the autograd engine's device thread) from
the rest of the backward: per thread, the time under top-level ops, its
share of the wall, and the engine thread's ops of most self CPU time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "olmo-1b"
BATCH, SEQ, TASKS = 8, 2048, 8
VARIANTS = {"none": None, "remat": {},
            "no_rng": {"preserve_rng_state": False},
            "lean": {"preserve_rng_state": False,
                     "determinism_check": "none"}}


def thread_table(prof, wall_us: float) -> list:
    """Per thread of a trace: top-level CPU op time, its share of the
    wall, the recomputation's time (``remat_layer`` ranges on that
    thread) and whether it ran the autograd engine."""
    rows = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            continue
        r = rows.setdefault(e.thread, dict(top_ms=0.0, remat_ms=0.0,
                                           n_top=0, engine=False))
        dur = (e.time_range.end - e.time_range.start) / 1e3
        if e.name.startswith("autograd::engine::evaluate_function"):
            r["engine"] = True
        if e.cpu_parent is None:
            r["top_ms"] += dur
            r["n_top"] += 1
        if e.name == "remat_layer":
            r["remat_ms"] += dur
    out = []
    for tid, r in rows.items():
        if not r["n_top"]:
            continue
        out.append(dict(thread=tid, engine=r["engine"],
                        top_ms=round(r["top_ms"], 1),
                        top_share=round(r["top_ms"] * 1e3 / wall_us, 3),
                        remat_ms=round(r["remat_ms"], 1),
                        top_ops=r["n_top"]))
    return sorted(out, key=lambda r: -r["top_ms"])


def thread_cpu() -> dict:
    """{thread id: (name, CPU seconds so far)} of this process's threads
    (``/proc``); the autograd engine's device thread is ``pt_autograd_0``
    and the Python threads ``python``."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/comm") as f:
                name = f.read().strip()
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        out[tid] = (name, (int(fields[11]) + int(fields[12])) / tick)
    return out


def cpu_per_thread(before: dict, after: dict, wall: float) -> list:
    """Threads' CPU seconds between two :func:`thread_cpu` readings and
    their share of ``wall``; threads under 1% of it left out."""
    rows = []
    for tid, (name, t) in after.items():
        d = t - before.get(tid, (name, 0.0))[1]
        if d >= 0.01 * wall:
            rows.append(dict(thread=name, cpu_s=round(d, 2),
                             share=round(d / wall, 3)))
    return sorted(rows, key=lambda r: -r["cpu_s"])


def engine_ops(prof, n: int = 8) -> list:
    """The ops with the most self CPU time on the engine thread(s)."""
    engine = {e.thread for e in prof.events()
              if e.name.startswith("autograd::engine::evaluate_function")}
    self_ms = {}
    for e in prof.events():
        if e.thread in engine and not str(e.device_type).endswith("CUDA"):
            self_ms[e.name] = self_ms.get(e.name, 0.0) + \
                e.self_cpu_time_total / 1e3
    top = sorted(self_ms.items(), key=lambda kv: -kv[1])[:n]
    return [(name[:60], round(ms, 1)) for name, ms in top]


def run_variant(name: str, flags, params, steps: int,
                workers: int) -> dict:
    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    import torch.utils.checkpoint as tuc
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.data import as_tensors, batch_for_step
    from repro_torch.models import build_model
    from repro_torch.models import common
    from repro_torch.runtime import RDLBTrainExecutor
    from repro_torch.runtime.executor import value_and_grad
    from chip_smoke import device_events, device_us

    cfg = get_config(ARCH)
    if flags is None:
        cfg = cfg.replace(remat_policy="everything_saveable")

    def traced(fn, *args, **kw):
        def layer(*a):
            with record_function("remat_layer"):
                return fn(*a)
        return tuc.checkpoint(layer, *args, **kw, **(flags or {}))

    common.checkpoint = traced
    model = build_model(cfg)
    dev = params["embed"].device
    out = dict(variant=name, remat_policy=cfg.remat_policy,
               checkpoint_flags=flags, workers=workers,
               switch_interval_s=sys.getswitchinterval())

    # one task alone, as a worker runs it
    batch = as_tensors(batch_for_step(cfg, 0, 1, SEQ), dev)
    fn = lambda p, b: model.loss(p, b)[0]  # noqa: E731
    value_and_grad(fn, params, batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        value_and_grad(fn, params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        value_and_grad(fn, params, batch)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    kernels = [e for e in device_events(prof) if e.key != "remat_layer"]
    busy = sum(device_us(e) for e in kernels) / 1e6
    top = [(e.key[:50], e.count, round(device_us(e) / 1e3, 2))
           for e in sorted(kernels, key=device_us, reverse=True)[:6]]
    out["task_alone"] = dict(
        wall_s=walls, traced_wall_s=traced_wall, device_busy_s=busy,
        kernels=sum(e.count for e in kernels), top_kernels_ms=top,
        threads=thread_table(prof, traced_wall * 1e6),
        engine_top_self_cpu_ms=engine_ops(prof))
    del prof

    # threaded rDLB steps
    spec = api.train_spec(technique="FAC", n_workers=workers,
                          n_tasks=TASKS, threaded=True)
    ex = RDLBTrainExecutor(model, spec=spec, optimizer="adamw", lr=1e-4,
                           exact_accumulation=True)
    p, opt_state = params, ex.opt.init(params)
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for step in range(steps + 1):
        if step == 1:
            cpu0, proc0 = thread_cpu(), time.process_time()
        batch = batch_for_step(cfg, step, BATCH, SEQ)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ex.train_step(p, opt_state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        p, opt_state = res.params, res.opt_state
    out["step_s"] = secs
    live = cpu_per_thread(cpu0, thread_cpu(), sum(secs[1:]))
    proc = time.process_time() - proc0
    out["warm_steps_cpu_per_thread"] = live
    out["warm_steps_cpu_s"] = dict(
        process=round(proc, 2), wall=round(sum(secs[1:]), 2),
        exited_threads=round(proc - sum(r["cpu_s"] for r in live), 2))
    out["first_step_s"] = secs[0]
    out["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    batch = batch_for_step(cfg, steps + 1, BATCH, SEQ)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.train_step(p, opt_state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(device_us(e) for e in device_events(prof)
               if e.key != "remat_layer") / 1e6
    out["traced_step"] = dict(wall_s=wall, device_busy_s=busy,
                              busy_share=busy / wall)
    del prof, ex, p, opt_state, res
    common.checkpoint = tuc.checkpoint
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--switch-interval", type=float, default=None)
    args = ap.parse_args()
    if args.switch_interval is not None:
        sys.setswitchinterval(args.switch_interval)
    import torch
    if not torch.cuda.is_available():
        print("torch_remat_overhead: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"gpu: {smi.stdout.strip()}", flush=True)
    params = build_model(get_config(ARCH)).init(0, device="cuda")
    for name in args.variants.split(","):
        print(json.dumps(run_variant(name, VARIANTS[name], params,
                                     args.steps, args.workers)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
