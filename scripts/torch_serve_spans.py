#!/usr/bin/env python3
"""Read the serving executor's spans in one traced run of a benchmark
cell: the flight recorder's group, prefill and decode-step rows
(``EV_GROUP``, ``EV_PREFILL``, ``EV_STEP``) beside what the benchmark's
harness reads from outside the program in the same run.

    python3 scripts/torch_serve_spans.py --workload <cell> --seed <n> \
        [--seconds 51] [--device cuda]

Runs ``portbench/run.py``'s traced run (``--trace 1``) in this process,
keeping each loop's engine trace and the profiled loop's device events,
and prints, as the last line, one JSON object with

  * ``spans``: step_span_ms and prefill_span_ms (mean walls over the
    window's loops), host_cpu_share (thread CPU of every group span over
    the loops' engine spans, in %), tail_wait_share (over the requests
    at or above the 95th percentile of the end of the first group to
    serve them, that group's start over that end, in %),
    idle_in_steps_share (% of the profiled loop's device-idle seconds
    whose gap middle lies in a prefill or step span of any thread, the
    spans laid on the profiler's clock by ``meta["t0_unix_ns"]``), the
    step spans' thread CPU over their wall, the least and largest share
    of a group's wall that its prefill, steps and capture cover, and the
    ms of a group before its prefill and after its last span;
    graph_step_share (the share of decode steps that replayed a CUDA
    graph, captured in their group or kept from an earlier one: the
    ``EV_GRAPH`` rows' sizes over the ``EV_STEP`` rows), graph_hit_share
    (the graphed groups that replayed a kept graph: ``EV_GRAPH`` rows
    with detail "hit" over those with "hit" or "capture"; a segmented
    prefill's rows, "prefill-hit" and "prefill-capture", are left out),
    captures and hits, and
    capture_ms (mean wall of the capturing ``EV_GRAPH`` rows: capture
    and instantiation);
  * ``harness``: the run's own metrics (``decode_step_ms`` among them),
    its idle-gap breakdown and the share of it charged to the harness's
    decode-step and prefill labels;
  * ``moe`` (a dropless MoE model, else null): the window's routed rows of
    each MoE layer from the program's device counter
    (``kernels.moe.ROWS_COUNTER``: rows, the largest expert's over the
    mean, the least and most rows, experts routed none), and the window's
    launches of the MoE and attention sites with their variants
    (``kernels.dispatch``); each layer's loads are also printed to
    standard error.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

#: the program's span names -> the harness's span kinds (profiling.LABELS);
#: a graph's capture is host work of the decode loop
KINDS = {"step": "decode_step", "graph": "decode_step", "prefill": "prefill",
         "group": "group"}


def step_share(gaps: dict) -> float | None:
    """% of the idle seconds charged to the decode-step and prefill
    labels of ``profiling.LABELS``."""
    from portbench import profiling
    labels = {label for kind, label in profiling.LABELS
              if kind in ("decode_step", "prefill")}
    total = sum(gaps.values())
    if not total:
        return None
    return 100.0 * sum(v for k, v in gaps.items() if k in labels) / total


def span_readings(traces: list, dev: list | None, sites) -> dict:
    """The readings of the window's engine traces (the profiled loop's
    first) and that loop's device events."""
    from repro_torch.core import trace as trc

    from portbench import profiling

    def mean_ms(kind):
        dts = np.concatenate([t.dt[t.kind == kind] for t in traces])
        return 1e3 * float(dts.mean()) if len(dts) else None

    def graph_rows(t, hit: bool):
        """The decode step's EV_GRAPH rows that hit (or captured); a
        segmented prefill's rows are "prefill-hit" / "prefill-capture"."""
        return np.array([i for i in np.flatnonzero(t.kind == trc.EV_GRAPH)
                         if t.details.get(int(i)) == ("hit" if hit
                                                      else "capture")],
                        dtype=np.int64)

    cpu = sum(float(t.aux[t.kind == trc.EV_GROUP].sum()) / 1e6
              for t in traces)
    wall = sum(t.span()[1] - t.span()[0] for t in traces)
    served = [v for t in traces for v in t.first_served().values()]
    start = np.array([a for a, _ in served])
    end = np.array([b for _, b in served])
    tail = end >= np.percentile(end, 95) if len(end) else end
    steps = [(t.aux[t.kind == trc.EV_STEP].sum() / 1e6,
              t.dt[t.kind == trc.EV_STEP].sum()) for t in traces]
    cover, before, after = [], [], []
    for t in traces:
        for g in np.flatnonzero(t.kind == trc.EV_GROUP):
            inner = np.flatnonzero(
                (t.wid == t.wid[g]) & (t.seq == t.seq[g])
                & (t.start == t.start[g])
                & np.isin(t.kind, (trc.EV_PREFILL, trc.EV_STEP,
                                   trc.EV_GRAPH)))
            cover.append(float(t.dt[inner].sum() / t.dt[g]))
            if len(inner):
                before.append(1e3 * float(t.t[inner].min() - t.t[g]))
                after.append(1e3 * float(t.t[g] + t.dt[g]
                                         - (t.t + t.dt)[inner].max()))
    least = int(np.argmin(cover)) if cover else None
    n_steps = int(sum((t.kind == trc.EV_STEP).sum() for t in traces))
    replayed = int(sum(t.size[np.concatenate([graph_rows(t, True),
                                              graph_rows(t, False)])].sum()
                       for t in traces))
    hits = sum(len(graph_rows(t, True)) for t in traces)
    capture_dt = np.concatenate([t.dt[graph_rows(t, False)] for t in traces])
    graphed = hits + len(capture_dt)
    out = dict(step_span_ms=mean_ms(trc.EV_STEP),
               graph_step_share=replayed / n_steps if n_steps else None,
               graph_hit_share=hits / graphed if graphed else None,
               captures=len(capture_dt), hits=hits,
               capture_ms=(1e3 * float(capture_dt.mean())
                           if len(capture_dt) else None),
               prefill_span_ms=mean_ms(trc.EV_PREFILL),
               host_cpu_share=100.0 * cpu / wall if wall else None,
               tail_wait_share=(100.0 * float(start[tail].sum())
                                / float(end[tail].sum()))
               if len(end) else None,
               step_cpu_over_wall=(float(sum(c for c, _ in steps))
                                   / float(sum(w for _, w in steps)))
               if sum(w for _, w in steps) else None,
               group_cover_min=min(cover) if cover else None,
               group_cover_max=max(cover) if cover else None,
               # ms of a group before its prefill and after its last
               # span: mean, largest, and in the least-covered group
               group_before_ms=[float(np.mean(before)), max(before),
                                before[least]] if before else None,
               group_after_ms=[float(np.mean(after)), max(after),
                               after[least]] if after else None,
               n_groups=len(cover), n_requests=len(served),
               n_steps=n_steps)
    if dev:
        spans = [(a, b, KINDS[k]) for a, b, k in traces[0].unix_spans()]
        s = profiling.summarize(dev, spans, sites)
        out["idle_gaps"] = dict(s["idle_gaps"])
        out["idle_in_steps_share"] = step_share(out["idle_gaps"])
    return out


def moe_readings(log=print) -> dict | None:
    """The window's per-layer expert loads and MoE dispatch counts (see
    the module), or None where no MoE layer counted rows."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import moe as km
    rows = dispatch.device_counters().get(km.ROWS_COUNTER)
    if rows is None or not int(rows.sum()):
        return None
    loads = []
    for i, r in enumerate(rows.cpu()):
        if r.sum() > 0:
            loads.append(dict(layer=i, rows=int(r.sum()),
                              max_over_mean=float(r.max() / r.double().mean()),
                              least=int(r.min()), most=int(r.max()),
                              empty=int((r == 0).sum())))
            log(f"expert loads, layer {i}: {r.tolist()}")
    sites = (km.SITE_ROUTE, km.SITE_GEMM, "flash_attention")
    return dict(expert_loads=loads,
                launches={s: dispatch.launches(s) for s in sites},
                variants={s: dispatch.variant_launches(s) for s in sites})


def read_cell(bench: dict, workload: str, *, seed: int, seconds: float,
              device: str = "cuda", limits: str | None = None,
              log=print) -> dict:
    """One traced run of ``workload`` -> {"spans": ..., "harness": ...}."""
    from repro_torch import api

    from portbench import harness, profiling, run
    traces: list = []
    dev: list = []
    api_run, read = api.run, profiling.read

    def keep(spec, eng):
        st = api_run(spec, eng)
        traces.append(st.trace)
        return st

    def keep_events(prof, sites, spans):
        if not dev:
            dev.extend(profiling._events(prof))
        return profiling.summarize(dev, spans, sites)
    api.run, profiling.read = keep, keep_events
    try:
        result = run.execute(bench, workload, seed=seed, seconds=seconds,
                             trace=True, device=device, limits=limits,
                             log=log)
    finally:
        api.run, profiling.read = api_run, read
    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    cell = harness.Cell(wl["config"], wl["traffic"], limits or workload)
    window = traces[1:]                 # traces[0]: the warm-up loop
    gaps = dict(result.get("breakdown", {}).get("idle_gaps", []))
    return dict(
        workload=workload, seed=seed, card=run.power_limit(),
        moe=moe_readings(log),
        spans=span_readings(window, dev, cell.config["sites"]),
        harness=dict(metrics={k: v["value"]
                              for k, v in result["metrics"].items()},
                     idle_gaps=gaps, idle_in_steps_share=step_share(gaps),
                     correct=result["correct"], loops=result["loops"],
                     device=result["device"]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from portbench import run

    def log(msg):
        print(f"serve_spans: {msg}", file=sys.stderr, flush=True)
    out = read_cell(run.load_benchmark(), args.workload, seed=args.seed,
                    seconds=args.seconds, device=args.device, log=log)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
