#!/usr/bin/env python3
"""Whether routing flips set DeepSeek-V2-Lite's served-token gaps.

For prompts of the ``prefill-failstop`` mix, the program's prefill on the
card (``model.prefill``, the serving path's) and the benchmark's float32
reference (``portbench/reference/deepseek_v2.py``) run over the same
weights, drawn from ``--seed`` as the benchmark draws them.  Both sides
record each MoE layer's top-k experts at every prompt position.  A flip
is a (layer, position) whose expert set differs between the two.

    python3 scripts/torch_moe_route_flips.py [--seed N] [--prompts 48]

Prints one line a prompt: its length, the served token's gap (the
reference's best logit minus the served token's, ``portbench/judge.py``'s
reading), the MoE layers whose last position flipped, and the share of
(layer, position) pairs that flipped.  Last, one JSON object: the largest
gap of the prompts with no flip at the last position and of those with
one, the reference's margin between its k-th and (k+1)-th probability at
the flips against at every routing, and the run's settings.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

CELL = "deepseek-v2-lite-16b.prefill-failstop"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=2 ** 33 + 28)
    p.add_argument("--prompts", type=int, default=48)
    p.add_argument("--config", default="deepseek-v2-lite-16b")
    p.add_argument("--mix", default="prefill-failstop")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from portbench import harness, run, traffic
    from repro_torch.kernels import moe as km
    cell = harness.Cell(args.config, args.mix, CELL)
    dev = torch.device(args.device)
    runner = harness.Runner(cell, args.seed, dev)
    model, params, cfg = cell.model, runner.params, cell.model_cfg
    ref, K = cell.ref, cfg.top_k

    prog_idx, ref_idx, ref_margin = [], [], []
    routed = km.routed_experts

    def record_prog(*a, **kw):
        out = routed(*a, **kw)
        prog_idx.append(out[1].long())
        return out
    ref_moe = ref._moe

    def record_ref(p_, h, model_, precision):
        probs = torch.softmax(ref.mm(h, p_["router"], precision), dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        ref_idx.append(idx[:, :K])
        ref_margin.append(vals[:, K - 1] - vals[:, K])
        return ref_moe(p_, h, model_, precision)
    km.routed_experts, ref._moe = record_prog, record_ref

    sizes = traffic.sizes(cell.mix["prompt_len"], cell.mix["loop_requests"])
    rng = traffic.rng(args.seed, 11)
    lens = rng.choice(np.asarray(sizes), size=args.prompts)
    rows, flip_margins, all_margins = [], [], []
    try:
        for S in (int(s) for s in lens):
            prompt = rng.integers(0, cfg.vocab_size, size=S).astype(np.int32)
            prog_idx.clear()
            ref_idx.clear()
            ref_margin.clear()
            with torch.inference_mode():
                cache = model.init_cache(1, S + 1, device=dev)
                lg, _ = model.prefill(params, cache, torch.from_numpy(
                    prompt)[None].to(dev))
                tok = int(torch.argmax(lg[0, -1]))
                del cache
            want = ref.logits(runner.weights, cell.model_dict, [prompt],
                              [[S - 1]], device=dev)[0][0]
            gap = float(want.max() - want[tok])
            flips_last, n_flip = [], 0
            for layer, (a, b, m) in enumerate(zip(prog_idx, ref_idx,
                                                  ref_margin)):
                differ = (torch.sort(a, dim=-1).values
                          != torch.sort(b, dim=-1).values).any(dim=-1)
                n_flip += int(differ.sum())
                if bool(differ[-1]):
                    flips_last.append(layer)
                flip_margins.append(m[differ].float().cpu())
                all_margins.append(m.float().cpu())
            share = n_flip / max(1, S * len(prog_idx))
            rows.append(dict(S=S, gap=gap, flips_last=flips_last,
                             flip_share=share))
            print(f"route flips S={S}: gap={gap:.4f} last-position flips "
                  f"in MoE layers {flips_last} of {len(prog_idx)}, "
                  f"(layer, position) flips {100 * share:.3f} %",
                  flush=True)
    finally:
        km.routed_experts, ref._moe = routed, ref_moe
    still = [r["gap"] for r in rows if not r["flips_last"]]
    moved = [r["gap"] for r in rows if r["flips_last"]]
    fm = torch.cat(flip_margins) if flip_margins else torch.zeros(0)
    am = torch.cat(all_margins)
    result = dict(
        card=run.power_limit() if dev.type == "cuda" else None,
        seed=args.seed, prompts=len(rows), top_k=K,
        max_gap_no_flip_at_last=max(still) if still else None,
        max_gap_flip_at_last=max(moved) if moved else None,
        prompts_with_flip_at_last=len(moved),
        gaps_over_0_1_with_flip_at_last=sum(g > 0.1 for g in moved),
        gaps_over_0_1_without=sum(g > 0.1 for g in still),
        flip_share=float(np.mean([r["flip_share"] for r in rows])),
        margin_at_flips_median=float(fm.median()) if fm.numel() else None,
        margin_at_flips_max=float(fm.max()) if fm.numel() else None,
        margin_median=float(am.median()))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
