#!/usr/bin/env python3
"""DeepSeek-V2-Lite's decode on the card against the benchmark's float32
reference, outside the benchmark: the benchmark's configuration (the
published routing and YaRN, full width and depth, bf16) and its weights
drawn from ``--seed``, then for each prompt length of the
``decode-failstop`` mix that the check takes (least, median, largest)
one request at B = 1: the prefill, then ``--steps`` greedy decode steps
through the cache (``model.decode_step``, the serving path's own).

    python3 scripts/torch_moe_decode_check.py [--seed N] [--steps 31]

(``--config deepseek-v2-lite-smoke --mix decode-smoke --device cpu``
rehearses it on the CPU, with no timing.)

Prints one line a request and, last, one JSON object with

  * ``gap``: the served tokens' gaps (the reference's best logit minus
    the served token's, ``portbench/judge.py``'s reading) and the program's
    logits against the reference's at every served position (largest
    absolute difference, and over the reference's logit spread), held to
    the cell's ``max_gap`` limit (``portbench/limits``);
  * ``step``: one decode step at the longest context: its wall ms and
    device-busy ms (``torch.profiler``, the union of its device intervals,
    and the MoE kernels' seconds) over ``--reps`` steps, the dispatch
    counts of the step
    (``moe_route``, ``moe_gemm`` by variant), the experts its tokens
    touched a layer (the program's row counter), and the bytes of weights
    a step reads (every non-expert weight, the shared experts, the
    touched routed experts) beside 28.8 GB for all 64 experts a layer.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

CELL = "deepseek-v2-lite-16b.prefill-failstop"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=2 ** 33 + 28)
    p.add_argument("--steps", type=int, default=31)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--config", default="deepseek-v2-lite-16b")
    p.add_argument("--mix", default="decode-failstop")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from portbench import harness, judge, run, traffic
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import moe as km
    bench = run.load_benchmark()
    wl = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert wl["config"] == "deepseek-v2-lite-16b"
    cell = harness.Cell(args.config, args.mix, CELL)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    runner = harness.Runner(cell, args.seed, dev)
    model, params, cfg = cell.model, runner.params, cell.model_cfg
    sizes = traffic.sizes(cell.mix["prompt_len"], cell.mix["loop_requests"])
    lens = [int(sizes[0]), int(sizes[len(sizes) // 2]), int(sizes[-1])]
    rng = traffic.rng(args.seed, 7)
    reqs, logits_prog = [], []
    for S in lens:
        prompt = rng.integers(0, cfg.vocab_size, size=S).astype(np.int32)
        n = args.steps + 1
        with torch.inference_mode():
            cache = model.init_cache(1, S + n, device=dev)
            lg, cache = model.prefill(params, cache,
                                      torch.from_numpy(prompt)[None].to(dev))
            steps = [lg[0, -1].float()]
            tok = torch.argmax(lg[:, -1], -1)
            out = [tok]
            for i in range(1, n):
                lg, cache = model.decode_step(params, cache, tok[:, None],
                                              S + i - 1)
                steps.append(lg[0, -1].float())
                tok = torch.argmax(lg[:, -1], -1)
                out.append(tok)
        r = harness.TimedRequest(rid=len(reqs), prompt=prompt,
                                 max_new_tokens=n)
        r.output = torch.cat(out).int().cpu().numpy()
        reqs.append(r)
        logits_prog.append(torch.stack(steps))
        del cache
    gaps, exact = judge.served_gaps(cell.ref, runner.weights,
                                    cell.model_dict, reqs, dev)
    per_req, diffs, spreads = [], [], []
    off = 0
    for r, lp, le in zip(reqs, logits_prog, exact):
        g = gaps[off:off + len(r.output)]
        off += len(r.output)
        d = float((lp - le).abs().max())
        spread = float(le.std())
        diffs.append(d)
        spreads.append(spread)
        per_req.append(dict(S=len(r.prompt), steps=len(r.output) - 1,
                            max_gap=float(g.max()), logit_max_abs_diff=d,
                            ref_logit_std=spread))
        print(f"decode check S={len(r.prompt)}: max_gap={g.max():.4f} "
              f"logits max|prog - ref|={d:.4f} (reference logit std "
              f"{spread:.3f})", flush=True)
    limit = cell.limits.get("max_gap")

    # one decode step at the longest context, timed and counted
    S = lens[-1]
    tok = torch.zeros((1, 1), dtype=torch.long, device=dev)
    with torch.inference_mode():
        cache = model.init_cache(1, S + args.reps + 2, device=dev)
        model.prefill(params, cache, torch.from_numpy(
            reqs[-1].prompt)[None].to(dev))
        model.decode_step(params, cache, tok, S)          # warm
        if on_card:
            torch.cuda.synchronize()
        dispatch.reset_launches()
        model.decode_step(params, cache, tok, S + 1)
        if on_card:
            torch.cuda.synchronize()
        counts = dict(route=dispatch.launches(km.SITE_ROUTE),
                      gemm=dispatch.variant_launches(km.SITE_GEMM),
                      flash_attention=dispatch.launches("flash_attention"))
        rows = dispatch.device_counters()[km.ROWS_COUNTER].cpu()
        touched = [int((r > 0).sum()) for r in rows if r.sum() > 0]
        timing = None                   # a CPU rehearsal times nothing
        if on_card:
            from torch.profiler import ProfilerActivity, profile

            from portbench import profiling
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(args.reps):
                    model.decode_step(params, cache, tok, S + 2 + i)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            s = profiling.summarize(profiling._events(prof), [],
                                    [km.SITE_ROUTE, km.SITE_GEMM])
            timing = dict(wall_ms=1e3 * wall / args.reps,
                          busy_ms=1e3 * s["busy_s"] / args.reps,
                          kernel_ms={k: 1e3 * v / args.reps
                                     for k, v in s["kernel_s"].items()},
                          top=s["device_ops"][:6])
    d, f = cfg.d_model, cfg.d_expert
    expert = 3 * d * f * 2
    n_all = sum(t.numel() * t.element_size() for t in params.parameters())
    routed_all = (cfg.n_layers - cfg.n_dense_layers) * cfg.n_routed_experts \
        * expert
    embed = cfg.vocab_size * d * 2                     # one row is read
    step_bytes = n_all - routed_all - embed + sum(touched) * expert
    result = dict(
        card=run.power_limit(), seed=args.seed, limit=limit,
        gap=dict(max_gap=float(gaps.max()), requests=per_req,
                 logit_max_abs_diff=max(diffs),
                 within_limit=bool(limit is not None
                                   and gaps.max() <= limit)),
        step=dict(context=S + 1, timing=timing, dispatch=counts,
                  touched_experts_a_layer=touched,
                  expert_gb=sum(touched) * expert / 1e9,
                  all_experts_gb=routed_all / 1e9,
                  weight_gb=step_bytes / 1e9,
                  weight_bound_ms=step_bytes / 3.35e12 * 1e3))
    print(json.dumps(result), flush=True)
    return 0 if result["gap"]["within_limit"] else 1


if __name__ == "__main__":
    sys.exit(main())
