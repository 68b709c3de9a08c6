#!/usr/bin/env python3
"""The serving executor's CUDA graph of the decode step, on the card:
olmo-1b at full width and depth in bfloat16, its decode loop walked from
Python (eager) against the graphs each lane keeps across request groups
(graphed).

    python3 scripts/torch_decode_graph.py [--seed 0] [--threads 1,4]

Weights: ``model.init(seed)`` on the card, the embedding redrawn from
N(0, 0.02^2) (OLMo's init: with N(0, 1) the tied head copies the input
token).  Requests: the sizes of a decode-heavy serving loop, drawn from
the seed: 16 requests, prompt lengths lognormal (median 128, sigma 0.8)
clipped to 16 .. 512, 8 .. 32 new tokens each.

Prints one JSON object a line, ``kind`` first:

  * ``host_profile`` (the eager step, before any graph), at each thread
    count T: the profiled thread decodes one group eagerly while T - 1
    other threads decode theirs; a step's wall, thread CPU and aten-op
    self CPU ms (``torch.profiler``'s CPU activity, the profiled
    thread's ops only), the Python left between ops, the top ops with
    their ms and calls a step;
  * ``serve`` at each thread count and mode: one threaded rDLB ``serve``
    of the requests (FAC, rDLB on, no failure, the flight recorder on):
    seconds, host ms a step (``EV_STEP`` walls; eager steps and replays
    apart), captures and hits (``EV_GRAPH`` rows with detail "capture"
    and "hit"), capture ms (the captures' walls: capture and
    instantiation), ``graph_step_share`` (sum of ``EV_GRAPH`` sizes over
    the number of ``EV_STEP`` rows), ``flash_decode`` launches against
    layers x steps and ``flash_attention`` launches against layers x
    prefills.  Modes: ``eager`` (a fresh cache of S + max_new slots a
    group, every step from Python), ``kept_eager`` (the lanes' kept
    caches of ``cache_capacity(S + max_new)`` slots, every step from
    Python: a stand-in capture that replays eagerly) and ``graphed``;
  * ``tokens`` at each thread count: the graphed serve's tokens against
    the ``kept_eager`` serve's (the same shapes: equal bit for bit) and
    the ``eager`` serve's, equal where one CTA reads a row's slots both
    ways (``flash_decode``'s split is a function of the cache's slots);
    each differing request with its ``max_gap`` (the model's best logit
    minus the served token's, teacher-forced in bfloat16, largest over
    the request's positions);
  * ``repeat``: the graphed serve at the most threads run again on fresh
    threads (``--repeat`` times), with its captures and hits, the lanes'
    kept (rows, capacity) states, and the device memory reserved and the
    peak allocated after each (a lane captures each (rows, capacity)
    once, so a serve without a capture reserves nothing);
  * ``device``: one group (prompt 128, 32 new tokens) on one thread: host
    and device ms of an eager step and of a replay (CUDA events around
    each), capture and instantiate ms apart, and ``torch.profiler``'s
    CUDA activity over a graphed ``FusedGenerator`` call (graph captured
    under the profiler) and over replays of a graph captured before it:
    ``flash_decode`` kernels found against layers x steps, its device ms
    a launch inside the graph, kernel ms a replay;

and last ``{"ok": ...}``: tokens equal, launch counts equal, one
capture a lane and (rows, capacity), reserved memory flat over repeats
without a capture, every replayed kernel seen by the profiler.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import trace as trc  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import RDLBServeExecutor, Request  # noqa: E402
from repro_torch.kernels.flash_attention import decode_splits  # noqa: E402
from repro_torch.runtime import serve_executor  # noqa: E402
from repro_torch.runtime.serve_executor import FusedGenerator  # noqa: E402

N_REQUESTS = 16
PROFILE_STEPS = 20
DEVICE_S, DEVICE_NEW, EPISODES = 128, 32, 3


def emit(kind: str, **kw) -> None:
    print(json.dumps(dict(kind=kind, **kw)), flush=True)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def build(seed: int):
    cfg = get_config("olmo-1b")
    model = build_model(cfg)
    params = model.init(seed, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    with torch.no_grad():
        params["embed"].normal_(0.0, 0.02, generator=gen)
    return cfg, model, params


def mix(seed: int, vocab: int) -> list:
    """(prompt, new tokens) of the loop's requests."""
    rng = np.random.default_rng(seed)
    lens = np.clip(np.round(np.exp(rng.normal(np.log(128), 0.8,
                                              N_REQUESTS))), 16, 512)
    new = rng.integers(8, 33, N_REQUESTS)
    return [(rng.integers(0, vocab, size=int(s)).astype(np.int32), int(n))
            for s, n in zip(lens, new)]


def one_cta(req) -> bool:
    """Whether ``flash_decode`` reads a row of this request's group as one
    CTA both from a fresh cache of S + max_new slots and from the kept
    cache of ``cache_capacity`` slots: then the two give the same bits."""
    total = len(req[0]) + req[1]
    return decode_splits(serve_executor.cache_capacity(total)) == 1 == (
        decode_splits(total))


def ms(xs) -> float | None:
    return 1e3 * float(statistics.mean(xs)) if len(xs) else None


# ------------------------------------------------------------- host profile
def eager_group(model, params, prompt: torch.Tensor, steps: int,
                timings: list | None = None) -> None:
    """A group's prefill and ``steps`` eager steps, as the generator's
    Python loop runs them; with ``timings``, each step is a profiler
    range named ``profiled_step`` and its (wall s, thread CPU s) is
    appended there."""
    S = prompt.shape[1]
    cache = model.init_cache(1, S + steps + 1, device=prompt.device)
    logits, _ = model.prefill(params, cache, prompt)
    tok = torch.argmax(logits[:, -1, :], dim=-1)
    out = torch.empty((1, steps), dtype=torch.int32, device=prompt.device)
    for i in range(steps):
        t0, c0 = time.perf_counter(), time.thread_time()
        with torch.profiler.record_function(
                "profiled_step" if timings is not None else "step"):
            logits, _ = model.decode_step(params, cache, tok[:, None],
                                          S + i)
            tok = torch.argmax(logits[:, -1, :], dim=-1)
            out[:, i] = tok
        if timings is not None:
            timings.append((time.perf_counter() - t0,
                            time.thread_time() - c0))
    out.cpu()


def host_profile(model, params, threads: int, seed: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, DEVICE_S),
                           generator=g).to(dev)
    stop = threading.Event()

    def other():
        with torch.inference_mode():
            while not stop.is_set():
                eager_group(model, params, prompt, PROFILE_STEPS)
    helpers = [threading.Thread(target=other) for _ in range(threads - 1)]
    with torch.inference_mode():
        eager_group(model, params, prompt, 4)               # warm
        for t in helpers:
            t.start()
        time.sleep(0.5 if helpers else 0.0)
        timings: list = []
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            eager_group(model, params, prompt, PROFILE_STEPS, timings)
    stop.set()
    for t in helpers:
        t.join()
    torch.cuda.synchronize()
    events = prof.events()

    def in_step(e) -> bool:
        p = e.cpu_parent
        while p is not None:
            if p.name == "profiled_step":
                return True
            p = p.cpu_parent
        return False
    ops: dict = {}
    calls: dict = {}
    py_us = 0.0
    for e in events:
        if e.name == "profiled_step":
            py_us += e.self_cpu_time_total
        elif in_step(e):
            ops[e.name] = ops.get(e.name, 0.0) + e.self_cpu_time_total
            calls[e.name] = calls.get(e.name, 0) + 1
    n = len(timings)
    return dict(threads=threads, steps=n,
                wall_ms=ms([w for w, _ in timings]),
                thread_cpu_ms=ms([c for _, c in timings]),
                aten_self_cpu_ms=sum(ops.values()) / 1e3 / n,
                python_between_ops_ms=py_us / 1e3 / n,
                events_a_step=sum(calls.values()) / n,
                top_ops=[[k, v / 1e3 / n, calls[k] / n] for k, v in sorted(
                    ops.items(), key=lambda kv: -kv[1])[:10]])


# -------------------------------------------------------------------- serve
class EagerGraph:
    """Stands in for a CUDA graph: a replay runs the step eagerly."""

    def __init__(self, step):
        self.replay = step


def eager_capture(step, lane):
    """A capture that keeps the step to run eagerly, its launches counted
    as they run."""
    return EagerGraph(step), dispatch.Tally()


def kept_states() -> int:
    """(rows, capacity) states with a graph, over every lane."""
    return sum(k.graph is not None for lanes in
               serve_executor._free_lanes.values() for ln in lanes
               for k in ln.kept.values())


def serve(cfg, model, params, reqs: list, threads: int,
          mode: str) -> tuple[dict, dict]:
    spec = api.serve_spec(technique="FAC", n_workers=threads,
                          rdlb_enabled=True, threaded=True)
    spec = spec.override("execution.trace", True)
    ex = RDLBServeExecutor(model, params, spec=spec)
    if mode == "eager":
        ex._fused.graphed = lambda device, steps: False
    kept = []
    run, capture, lanes = api.run, serve_executor._capture, None
    if mode == "kept_eager":            # lanes of their own, dropped after
        lanes = serve_executor._free_lanes
        serve_executor._free_lanes = {}
        serve_executor._capture = eager_capture

    def keep(s, eng):
        kept.append(run(s, eng))
        return kept[-1]
    rs = [Request(i, p, max_new_tokens=n) for i, (p, n) in enumerate(reqs)]
    api.run = keep
    dispatch.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        stats = ex.serve(rs)
    finally:
        api.run, serve_executor._capture = run, capture
        if lanes is not None:
            serve_executor._free_lanes = lanes
    wall = time.perf_counter() - t0
    tr = kept[-1].trace
    steps = np.flatnonzero(tr.kind == trc.EV_STEP)
    graphs = np.flatnonzero(tr.kind == trc.EV_GRAPH)
    hits = np.array([g for g in graphs if tr.details.get(int(g)) == "hit"],
                    dtype=np.int64)
    captures = np.setdiff1d(graphs, hits)
    replay = np.zeros(len(tr.kind), dtype=bool)
    for g in graphs:
        replay |= ((tr.wid == tr.wid[g]) & (tr.seq == tr.seq[g])
                   & (tr.start == tr.start[g]) & (tr.kind == trc.EV_STEP)
                   & (tr.t >= tr.t[g]))
    n_steps = len(steps)
    n_prefills = int((tr.kind == trc.EV_PREFILL).sum())
    fd = dispatch.launches("flash_decode")
    fa = dispatch.launches("flash_attention")
    out = dict(
        threads=threads, mode=mode,
        seconds=wall, hung=stats.hung, duplicates=stats.n_duplicates,
        groups=int((tr.kind == trc.EV_GROUP).sum()), steps=n_steps,
        step_ms=ms(tr.dt[steps]),
        eager_step_ms=ms(tr.dt[steps[~replay[steps]]]),
        replay_step_ms=ms(tr.dt[replay]),
        step_cpu_over_wall=float(tr.aux[steps].sum() / 1e6
                                 / tr.dt[steps].sum()),
        prefill_ms=ms(tr.dt[tr.kind == trc.EV_PREFILL]),
        captures=len(captures), hits=len(hits),
        counted_captures=dispatch.events(serve_executor.GRAPH_CAPTURES),
        counted_hits=dispatch.events(serve_executor.GRAPH_HITS),
        capture_ms=ms(tr.dt[captures]),
        capture_cpu_ms=(float(tr.aux[captures].mean()) / 1e3
                        if len(captures) else None),
        graph_step_share=(float(tr.size[graphs].sum()) / n_steps
                          if n_steps else None),
        flash_decode_launches=fd, layers_x_steps=cfg.n_layers * n_steps,
        flash_attention_launches=fa,
        layers_x_prefills=cfg.n_layers * n_prefills,
        memory_reserved_gb=torch.cuda.memory_reserved() / 1e9,
        memory_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out, {r.rid: r.output for r in rs}


def max_gap(model, params, prompt: np.ndarray, served: np.ndarray) -> float:
    """Largest best-logit minus served-token logit over the served
    positions, the served tokens fed back (bfloat16 forward)."""
    seq = np.concatenate([prompt, served[:-1]]).astype(np.int64)
    with torch.inference_mode():
        logits = model.forward(params, torch.from_numpy(seq)[None].cuda()
                               )[0][0, len(prompt) - 1:].float()
    want = torch.from_numpy(served.astype(np.int64)).cuda()
    gap = logits.max(dim=-1).values - logits.gather(-1, want[:, None])[:, 0]
    return float(gap.max())


# ------------------------------------------------------------------ device
def kernel_events(prof) -> list:
    from torch.autograd import DeviceType
    return [(e.name(), (e.end_ns() - e.start_ns()) / 1e6)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def device_timing(cfg, model, params, seed: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    S, new = DEVICE_S, DEVICE_NEW
    g = torch.Generator().manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (1, S), generator=g).to(dev)
    out = {}
    with torch.inference_mode():
        # graphed FusedGenerator calls under the profiler, as in a traced
        # benchmark loop: on a fresh lane the graph is captured and
        # replayed while the profiler runs, then a second call replays
        # the graph the lane kept
        gen = FusedGenerator(model)
        gen(params, prompt.cpu().numpy(), new)              # warm
        torch.cuda.synchronize()
        lanes, serve_executor._free_lanes = serve_executor._free_lanes, {}
        try:
            for label in ("under_profiler", "under_profiler_hit"):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    gen(params, prompt.cpu().numpy(), new)
                    torch.cuda.synchronize()
                fd = [t for n, t in kernel_events(prof)
                      if "flash_decode" in n]
                out[label] = dict(steps=new - 1,
                                  flash_decode_kernels=len(fd),
                                  layers_x_steps=cfg.n_layers * (new - 1))
        finally:
            serve_executor._free_lanes = lanes

        cache = model.init_cache(1, S + new, device=dev)
        logits, _ = model.prefill(params, cache, prompt)
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            tok_in = torch.argmax(logits[:, -1, :], dim=-1)[:, None].clone()
            pos = torch.full((), S, dtype=torch.int32, device=dev)

            def step():
                lg, _ = model.decode_step(params, cache, tok_in, pos)
                tok_in.copy_(torch.argmax(lg[:, -1, :], dim=-1)[:, None])
                pos.add_(1)

            def timed(fn, n):
                """(host s, device ms) of each of n calls of fn."""
                host, evs = [], []
                for _ in range(n):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    t0 = time.perf_counter()
                    a.record()
                    fn()
                    b.record()
                    host.append(time.perf_counter() - t0)
                    evs.append((a, b))
                torch.cuda.synchronize()
                return host, [a.elapsed_time(b) for a, b in evs]

            eh, ed = timed(step, 8)                  # positions S .. S+7
            pos.fill_(S + 1)
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            graph.capture_begin(capture_error_mode="thread_local")
            step()
            t1 = time.perf_counter()
            graph.capture_end()
            t2 = time.perf_counter()
            rh, rd = [], []
            for _ in range(EPISODES):
                pos.fill_(S + 1)
                h, d = timed(graph.replay, new - 2)
                rh += h
                rd += d
            pos.fill_(S + 1)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(new - 2):
                    graph.replay()
                torch.cuda.synchronize()
            ev = kernel_events(prof)
        cur.wait_stream(side)
        torch.cuda.synchronize()
        fd = [t for n, t in ev if "flash_decode" in n]
        n_rep = new - 2
        out.update(
            eager_step_host_ms=ms(eh), eager_step_device_ms=float(
                np.median(ed)),
            replay_host_ms=ms(rh),
            replay_device_ms=float(np.median(rd)),
            replay_device_ms_mean=float(np.mean(rd)),
            capture_ms=1e3 * (t1 - t0), instantiate_ms=1e3 * (t2 - t1),
            replays_profiled=n_rep, flash_decode_kernels=len(fd),
            layers_x_replays=cfg.n_layers * n_rep,
            flash_decode_ms_a_launch=float(np.mean(fd)) if fd else None,
            kernel_ms_a_replay=sum(t for _, t in ev) / n_rep,
            kernels_a_replay=len(ev) / n_rep,
            weights_bound_ms=sum(p.numel() * p.element_size()
                                 for p in params.parameters())
            / 3.35e12 * 1e3)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--threads", default="1,4")
    p.add_argument("--repeat", type=int, default=4,
                   help="graphed serves repeated at the most threads, "
                   "each on fresh threads (memory kept across groups)")
    args = p.parse_args(argv)
    threads = [int(t) for t in args.threads.split(",")]
    emit("card", card=card(), torch=torch.__version__,
         cuda=torch.version.cuda)
    cfg, model, params = build(args.seed)
    reqs = mix(args.seed, cfg.vocab_size)
    ok = True
    for t in threads:
        emit("host_profile", **host_profile(model, params, t, args.seed))
    serve(cfg, model, params, reqs[:4], max(threads), "graphed")  # warm
    for t in threads:
        runs = {}
        for mode in ("eager", "kept_eager", "graphed"):
            rec, toks = serve(cfg, model, params, reqs, t, mode)
            emit("serve", **rec)
            ok &= (rec["flash_decode_launches"] == rec["layers_x_steps"]
                   and rec["flash_attention_launches"]
                   == rec["layers_x_prefills"] and not rec["hung"]
                   and rec["counted_captures"] == rec["captures"]
                   and rec["counted_hits"] == rec["hits"])
            runs[mode] = toks
        got = runs["graphed"]

        def differ(base):
            return [dict(rid=rid, new=len(got[rid]),
                         one_cta=one_cta(reqs[rid]),
                         first=int(np.argmax(runs[base][rid] != got[rid])),
                         max_gap_graphed=max_gap(model, params, reqs[rid][0],
                                                 got[rid]),
                         max_gap_base=max_gap(model, params, reqs[rid][0],
                                              runs[base][rid]))
                    for rid in got
                    if not np.array_equal(runs[base][rid], got[rid])]
        same_shapes, fresh = differ("kept_eager"), differ("eager")
        emit("tokens", threads=t, requests=len(got),
             differ_kept_eager=same_shapes, differ_eager=fresh,
             one_cta_requests=sum(one_cta(r) for r in reqs))
        ok &= not same_shapes and not any(d["one_cta"] for d in fresh)
    before = kept_states()
    captured = 0
    reserved = None
    for i in range(args.repeat):
        rec, _ = serve(cfg, model, params, reqs, max(threads), "graphed")
        captured += rec["captures"]
        emit("repeat", index=i, kept_states=kept_states(),
             **{k: rec[k] for k in (
                 "seconds", "step_ms", "captures", "hits", "capture_ms",
                 "graph_step_share", "memory_reserved_gb",
                 "memory_peak_gb")})
        if not rec["captures"] and reserved is not None:
            ok &= rec["memory_reserved_gb"] == reserved
        reserved = rec["memory_reserved_gb"]
    # each capture adds a (lane, rows, capacity) state: none is captured
    # twice
    ok &= kept_states() - before == captured
    dev = device_timing(cfg, model, params, args.seed)
    emit("device", **dev)
    ok &= (dev["flash_decode_kernels"] == dev["layers_x_replays"]
           and all(dev[k]["flash_decode_kernels"]
                   == dev[k]["layers_x_steps"]
                   for k in ("under_profiler", "under_profiler_hit")))
    emit("ok", ok=bool(ok), card=card())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
