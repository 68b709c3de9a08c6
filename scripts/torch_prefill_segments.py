#!/usr/bin/env python3
"""rwkv6's prefill in segments replayed from CUDA graphs, on the card:
rwkv6-1.6b at full width and depth in bfloat16, what a segment of each
length costs, which pair of segment lengths serves the prefill cell's
prompts in the least device time, and where the segmented and the
one-shot prefill pick different greedy tokens, how near the tie was.

    python3 scripts/torch_prefill_segments.py [--seed 0]
        [--lengths 64,128,256,512,1024,2048] [--groups 16]

Weights: ``model.init(seed)`` on the card.  Prompt lengths: the
benchmark's prefill mix (``portbench/traffic/prefill-failstop.json``,
its 64 sizes).  Prints one JSON object a line, ``kind`` first:

  * ``segment`` for each length C: one segment of C real tokens (one
    request) captured into a CUDA graph after an eager run, then
    replayed: device ms a replay (CUDA events around 20 back-to-back
    replays on a side stream, the median of 3 such), host ms to launch
    one, capture ms, and the eager one-shot prefill of C tokens: its
    wall ms (host-bound) and device ms (CUDA events around it);
  * ``plan`` for each pair (long, short) of the lengths: over the mix's
    sizes, the mean segments and padded tokens a prompt and the device
    ms a prompt predicted from the ``segment`` rows (the sum of its
    segments' ms); the pair this checkout uses is marked ``current``;
  * ``ties``: for the first ``--groups`` sizes of the mix (one prompt
    each), the last logits of the one-shot prefill (``model.prefill``),
    of the segmented prefill (the executor's segments, replayed from
    its lane's graphs once captured) and of a float32 copy of the model
    (the same weights) prefilling one-shot: for each prompt whose two
    bf16 argmaxes differ, each side's gap between its two largest
    logits, and the argmax the float32 copy picks and its own gap; then
    how many prompts agree, and how often the float32 copy sides with
    each;

and last ``{"ok": true}``.  Each line also carries the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def emit(kind: str, **kw) -> None:
    print(json.dumps(dict(kind=kind, **kw)), flush=True)


def time_segment(model, params, C: int, dev, lane) -> dict:
    """One C-token segment: eager run, capture, timed replays."""
    import torch
    from repro_torch.runtime import serve_executor as se
    g = torch.Generator(device=dev).manual_seed(C)
    tok = torch.randint(0, model.cfg.vocab_size, (1, C), device=dev,
                        generator=g, dtype=torch.int64).int()
    state = model.init_cache(1, 0, device=dev)
    st = dict(state, valid=torch.tensor(C, dtype=torch.int32, device=dev))
    out = {}

    def step() -> None:
        out["logits"], _ = model.prefill(params, st, tok)
    with torch.inference_mode(), se._on(lane):
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph, _ = se._capture(step, lane)
        capture_ms = 1e3 * (time.perf_counter() - t0)
        graph.replay()
        torch.cuda.synchronize()
        reps, host = [], []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            for _ in range(20):
                graph.replay()
            host.append(1e3 * (time.perf_counter() - t0) / 20)
            b.record()
            b.synchronize()
            reps.append(a.elapsed_time(b) / 20)
        fresh = model.init_cache(1, 0, device=dev)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        model.prefill(params, fresh, tok)
        b.record()
        b.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    del graph
    return dict(C=C, replay_ms=statistics.median(reps),
                replay_ms_all=reps, launch_host_ms=statistics.median(host),
                capture_ms=capture_ms, eager_wall_ms=wall,
                eager_event_ms=a.elapsed_time(b))


def plan_of(S: int, long: int, short: int) -> list:
    """The executor's rule (``serve_executor.prefill_segments``) for any
    pair: long while more than short remain, then short, the last
    padded."""
    out = []
    while S > 0:
        C = long if S > short else short
        out.append((C, min(C, S)))
        S -= C
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lengths", default="64,128,256,512,1024,2048")
    p.add_argument("--groups", type=int, default=16)
    args = p.parse_args(argv)
    import numpy as np
    import torch
    from portbench import traffic
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.runtime import serve_executor as se
    dev = torch.device("cuda")
    _build.library()
    name = card()
    cfg = get_config("rwkv6-1.6b")
    model = build_model(cfg)
    params = model.init(args.seed, device=dev)
    mix = traffic.load(ROOT / "portbench" / "traffic" /
                       "prefill-failstop.json")
    sizes = traffic.sizes(mix["prompt_len"], mix["loop_requests"])
    lengths = [int(x) for x in args.lengths.split(",")]
    rows = {}
    for C in lengths:
        # a lane a length: a pool whose graphs are all gone takes no
        # capture again
        rows[C] = time_segment(model, params, C, dev, se._Lane(dev))
        emit("segment", card=name, **rows[C])
    current = (se.SEGMENT_LONG, se.SEGMENT_SHORT)
    for i, long in enumerate(lengths):
        for short in lengths[:i]:
            plans = [plan_of(int(S), long, short) for S in sizes]
            assert (long, short) != current or plans == [
                se.prefill_segments(int(S)) for S in sizes]
            emit("plan", card=name, long=long, short=short,
                 current=(long, short) == current,
                 segments=float(np.mean([len(q) for q in plans])),
                 padded=float(np.mean([sum(C - n for C, n in q)
                                       for q in plans])),
                 device_ms=float(np.mean([sum(rows[C]["replay_ms"]
                                              for C, _ in q)
                                          for q in plans])))
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=(1, int(S)))
               .astype(np.int32) for S in rng.permutation(sizes)[:args.groups]]
    ties(model, params, prompts, dev, name)
    emit("ok", ok=True, card=name)
    return 0


def top2(logits) -> tuple:
    """(argmax as the executor takes it, gap between the two largest) of
    a (V,) float32 row."""
    v = logits.topk(2).values
    return int(logits.argmax()), float(v[0] - v[1])


def ties(model, params, prompts: list, dev, name: str) -> None:
    """The ``ties`` lines of the module docstring."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.runtime import serve_executor as se
    gen = se.FusedGenerator(model)
    model32 = build_model(model.cfg.replace(dtype="float32"))
    params32 = tree_map(
        lambda t: t.float() if t.is_floating_point() else t, params)
    agree, sides = 0, {"one_shot": 0, "segmented": 0, "neither": 0}
    with torch.inference_mode():
        for p in prompts:
            tok = torch.from_numpy(p).to(dev)
            one = model.prefill(params, model.init_cache(1, 0, device=dev),
                                tok)[0][0, -1].float()
            with se._lane(dev, model, params, (se._Segments, 1)) as lane, \
                    se._on(lane):
                segs = lane.segments(model, params, 1, dev)
                seg = gen._prefill_segments(params, lane, segs, tok)[0]
                seg = seg[0, -1].float()
            ref = model32.prefill(params32,
                                  model32.init_cache(1, 0, device=dev),
                                  tok)[0][0, -1]
            (a, ga), (b, gb), (c, gc) = top2(one), top2(seg), top2(ref)
            if a == b:
                agree += 1
                continue
            side = ("one_shot" if c == a else "segmented" if c == b
                    else "neither")
            sides[side] += 1
            # the float32 copy's logit of the one-shot pick over the
            # segmented pick
            lead = float(ref[a] - ref[b])
            emit("ties", card=name, S=p.shape[1],
                 one_shot=dict(argmax=a, top2_gap=ga),
                 segmented=dict(argmax=b, top2_gap=gb),
                 float32=dict(argmax=c, top2_gap=gc,
                              one_shot_over_segmented=lead),
                 float32_sides_with=side,
                 max_abs_logit_gap=float((one - seg).abs().max()))
    emit("ties", card=name, prompts=len(prompts), agree=agree,
         float32_sides_with=sides)


if __name__ == "__main__":
    sys.exit(main())
