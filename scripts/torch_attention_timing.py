#!/usr/bin/env python3
"""Time the port's full-sequence attention kernel (flash_attention) on one
GPU at the causal bf16 shapes its paths launch: olmo-1b's training row
(16 heads of 128, S = 2048), the prefills of hymba-1.5b (25 heads over 5
of 64), paligemma-3b (8 over 1 of 256) at 37, 64 and 1000 tokens, and
deepseek-v2-lite-16b's MLA forward (16 heads, D = 192, Dv = 128) at 1000.
Each shape is held to the plain version (``chip_smoke.py``'s bf16
tolerance), launched twice for the same bits, and timed as a CUDA graph
of launches beside its bound and SDPA (K/V repeated to H heads), with
the variant that ran.

    python3 scripts/torch_attention_timing.py [--src DIR] [--label NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two versions of the kernel can be
compared on one card in turns, each in its own process.  The last line
is one JSON object with the timed shapes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, S, H, KV, D, Dv)
SHAPES = [("olmo-1b training", 2048, 16, 16, 128, 128)] + [
    (f"{arch} prefill, {S} tokens", S, H, KV, D, D)
    for arch, H, KV, D in (("hymba-1.5b", 25, 5, 64),
                           ("paligemma-3b", 8, 1, 256))
    for S in (37, 64, 1000)] + [
    ("deepseek-v2-lite-16b MLA forward", 1000, 16, 16, 192, 128)]
REPS = 20


def time_shape(dev, gen, label, S, H, KV, D, Dv) -> dict:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import flash_attention as kf
    q = torch.randn((1, S, H, D), generator=gen).to(dev, torch.bfloat16)
    k = torch.randn((1, S, KV, D), generator=gen).to(dev, torch.bfloat16)
    v = torch.randn((1, S, KV, Dv), generator=gen).to(dev, torch.bfloat16)
    out, lse = kf.flash_attention_forward(q, k, v, causal=True)
    variant = dispatch.status("flash_attention").get("variant")
    again = kf.flash_attention_forward(q, k, v, causal=True)
    same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    pout, _ = kf.flash_attention_forward_plain(q, k, v, causal=True)
    tol = 1e-4 + 2.0 ** -7 * pout.float().abs() + kf.bf16_p_bound(
        q, k, v, causal=True)
    d = (out.float() - pout.float()).abs()
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + H * S * Dv) \
        + 4 * H * S
    bound, by = cs.bound_ms(n_bytes, cs.attention_ops(1, H, S, D, Dv, True),
                            peak=cs.PEAK_BF16)
    ms = cs.graph_ms(lambda: kf.flash_attention_forward(q, k, v,
                                                        causal=True), REPS)
    g = H // KV
    qh, kh, vh = (t.transpose(1, 2) for t in (
        q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = cs.call_ms(lambda: sdpa(qh, kh, vh, is_causal=True), REPS)
    row = dict(shape=label, S=S, H=H, KV=KV, D=D, Dv=Dv, variant=variant,
               max_abs_err=float(d.max()), within=bool((d <= tol).all()),
               repeat_equal=same, ms=ms, bound_ms=bound, bound_by=by,
               sdpa_ms=lib)
    print(",".join(f"{k}={v}" for k, v in row.items()))
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_attention_timing: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"gpu: {smi.stdout.strip()}")
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke
    from repro_torch.kernels import _build
    _build.library(rebuild=True)
    for src, name, regs, spills in chip_smoke.ptxas_entries(
            _build.build_log):
        if "wgmma" in name:
            print(f"ptxas,{src},{name},{regs},{spills}")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(9)
    rows = [time_shape(dev, gen, *shape) for shape in SHAPES]
    print(json.dumps({"label": args.label, "src": args.src,
                      "gpu": torch.cuda.get_device_name(0),
                      "power": smi.stdout.strip(), "shapes": rows}))
    return 0 if all(r["within"] and r["repeat_equal"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
