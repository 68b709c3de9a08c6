#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal when it fails:

  1. print the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/csrc`` and print the build time and ptxas report
     (registers, shared memory and spills of the wgmma flash_attention,
     the flash_decode, the two wkv6, the mandelbrot and the spin_image
     kernels on lines of their own; a spill in a wgmma flash_attention
     instance fails);
     hold the built ``wkv6_batched_smem`` (ctypes) to the wrapper's
     ``_batched_smem`` at the shapes used; count the HGMMA (wgmma) and
     UTMALDG (TMA load) instructions in each (D, Dv) instance of the
     built flash_attention wgmma kernel (``cuobjdump -sass``), both
     required in every one of ``WGMMA_DIMS``;
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes of the main paths, with the tolerance printed, and time
     both: the kernel as a CUDA graph of launches (``ms``), in a profiler
     trace (``trace_ms``) and per back-to-back call (``call_ms``), and,
     where one PyTorch call computes the same function, that call
     (``library_ms``).  mandelbrot and spin_image agree exactly, at the
     shapes the paper path launches: mandelbrot on the 512 x 512 image
     and on each of its 64 tiles as strided views of the grid, timed at
     the image, the deepest and the lightest tile (beside the deepest
     pixel's dependent-chain floor) and the 64 tiles in turn;
     spin_image at every FAC chunk size of the PSIA run (2,500 down to 1
     centers, each with its cloud split printed), at 2,048 centers, on a
     cloud one point short, on one 12 bytes off 16-byte alignment (the
     element loads) and on points placed on bin edges, each launched
     twice (bit for bit), each chunk size timed, and the share
     of pairs that the fast binning's guard sends to the correctly
     rounded chain (its plain mirror over the whole run);
     flash_decode (olmo-1b's 8 x 16 rows of 128 at L = 1016, 1024, 100
     and 300, float32 and bfloat16, scattered and fully masked blocks,
     with the CTAs per row printed; timed at L = 1016 and 80; and at the
     serving path's own B = 1, 16 rows at L = 53, 80 and 1016, each held,
     timed beside its bound and SDPA, the row's ``shapes``),
     wkv6_decode and wkv6_batched within float32 rounding at
     rwkv6-1.6b's heads of 64, BH = 32 (one request, the serving path's
     shape) and 256 (B = 8): decode at both, batched at BH = 32 with
     T = 37, 64, 256, 1000 and 1024 (256 and 1024: a segmented
     prefill's segments) and at BH = 256 with T = 64, with w = 0.01, the
     state written in place and a repeated launch (bit for bit), each
     with its column split (CTAs a head) printed and timed beside its
     bound; batched at T = 256 and 1024 with a padded tail (k = 0,
     w = 1 past a real count) against the unpadded launch: bit for bit
     where the padding fills whole chunks, within 1e-4 elsewhere;
     WKV6BatchedFn (the wkv6_batched kernel's forward, the
     backward in PyTorch ops) against autograd through the plain version
     at the training shape (BH = 32, T = 4,096, bfloat16), a ragged
     T = 1,000 in float32 and bfloat16 and under strong decay (w = 0.01),
     every gradient within 1e-4 (float32) or 2**-6 (bfloat16) of its
     largest magnitude, and one backward at the training shape timed
     beside the kernel's forward, with the kernels it launches;
     the dropless MoE kernels (moe_route, moe_gemm's gate-up and down)
     against route_plain, schedule_plain and experts_plain on the same
     card tensors at DeepSeek-V2-Lite's widths and published routing,
     at prompts of 256, 1024 and 2040 tokens and decode steps of 1 and
     4 (``MOE_TOKENS``), each kernel's device ms beside the layer's
     bound from the experts its inputs touched;
  3. drive the paper's main path through the public API: threaded rDLB
     self-scheduling of the paper's Mandelbrot (512 x 512, 256
     iterations, SS, P=4) and PSIA (20,000 spin images over 16,384
     points, FAC, P=4), each with one worker that fail-stops.  Launch
     counts are set to 0 just before and read just after; every kernel
     must have launched.  The results must equal failure-free runs bit
     for bit, and a few tiles and spin images must equal the plain
     version computed on the CPU.  One failure-free run of each app is
     then traced: its kernel's device ms summed over the run;
  4. drive the serving path for olmo-1b and rwkv6-1.6b at full width and
     half depth (8 and 12 layers, ``EARLIER_DEPTH``) in bfloat16 with
     seeded random weights: threaded rDLB (SS, P=4) over
     16 requests of prompt lengths 37, 64 and 1000, 16 new tokens each,
     worker 1 fail-stopping after 2 requests.  Launch counts are set to 0
     just before each run and read just after: flash_decode must have
     launched in olmo-1b's, wkv6_decode and wkv6_batched in
     rwkv6-1.6b's.  Every request's tokens must equal a failure-free
     run's bit for bit, with at least one rDLB duplicate.  A float32 copy
     of each config cut to 2 layers (full width) must give the same
     greedy tokens through the kernels as through their plain versions,
     both on the card.  rwkv6-1.6b also times ``model.prefill`` of one
     1000-token prompt (B = 1), and the path serving runs for it there:
     FusedGenerator's segmented prefill of the same prompt, the calls
     that captured apart from those that replayed.  Then decode
     throughput: FusedGenerator at B = 8, S = 64, 64 new tokens, and one
     profiled call of 8 new tokens for the kernels per token position,
     the device's busy share and the ops that take the most host time;
  5. training: flash_attention (output and log-sum-exp, and the variant
     that ran) against its plain version at olmo-1b's training shape (16
     heads, S = 2048, D = 128, bfloat16, causal), a ragged GQA shape (8
     heads over 2, S = 1000, float32 and bfloat16), non-causal, Dv != D
     (192 / 128: float32 on the fp32 variant, bfloat16 on wgmma), head
     dims 64 and 256 shapes, and the gradients through
     FlashAttentionFn against autograd through the plain version, then
     timed like the others, with SDPA as its library call; rDLB training
     of olmo-1b at full width and half depth in bfloat16 (global batch 8 x 2048 tokens,
     8 tasks, P = 4 threads, FAC, adamw, exact accumulation, 3 steps),
     once failure-free and once with worker 1 fail-stopping during step
     1: the parameters after every step must be equal bit for bit, the
     losses finite, and flash_attention must have launched on the path,
     every launch of a step in its wgmma variant; a float32 copy cut to 2
     layers gives loss and gradients through the kernel within a stated
     tolerance of the plain path's, both on the card.  Then the same for
     rwkv6-1.6b at full width and half depth (8 x 4,096 tokens, the
     reference's train_4k cell), whose wkv6_batched must have launched
     on its training path (twice a layer: every layer is rematerialised,
     as every olmo-1b layer is under its ``remat_policy``); step seconds,
     tokens/s, duplicates, peak memory and one profiled task of each; and
     the train CLI's checkpoint/restart on the card (``--smoke --no-rdlb
     --fail 2:1 --ckpt-dir <tmp> --ckpt-interval 1``, both archs): the
     hung step restores the last checkpoint and the run finishes with the
     losses of a failure-free run;
  6. the other model families at full width in bfloat16 with seeded
     weights: deepseek-v2-lite-16b (MLA + 64 routed experts, top-6; full
     depth; the benchmark's configuration, with the published dropless
     routing and YaRN, its run launching moe_route once and moe_gemm
     twice a MoE layer a call, both variants) and hymba-1.5b (16 of 32 layers, ``FAMILY_DEPTH``) through
     phase 4's serving drive (fail-stop tokens equal
     a failure-free run's bit for bit, at least one duplicate; hymba's
     run must launch flash_decode and flash_attention), each with its
     peak memory, ms per decode step at B = 1 beside the bytes of
     weights a step reads, and one 1000-token ``model.prefill``; a
     float32 copy of deepseek cut to 2 layers (dense, then MoE) gives the
     CPU's greedy tokens and last logits within a stated tolerance, its
     MLA forward through flash_attention; hymba's (global, then windowed)
     the plain versions' tokens; paligemma-3b and whisper-tiny serve a
     few requests (``FEW_PROMPTS``), flash_decode launching at D = 256
     (8 heads over one) and D = 64, paligemma's flash_attention
     launches counted per variant (all wgmma); both attention kernels
     held and timed at every cache and prefill shape these serving
     drives launch them at (each prompt's last decode step, with its slot
     mask), beside their bounds and SDPA, flash_attention launched twice
     for the same bits and, on the wgmma variant, also timed on the fp32
     variant (paligemma's prefills at D = 256 and MLA's bf16 forward at
     192 / 128 among them); and all ten smoke configs in
     float32, card against CPU: logits, three decode steps, a loss and
     its gradients (aux and MTP included);
  7. the batched simulator (``core/devicesim``, no kernel: batched
     float64 PyTorch ops) at the reference's benchmark sizes:
     ``benchmarks/fig_scale.py``'s device sweep point (P = 1024, N =
     131,072 unit tasks of 0.01 s, h = 1e-6, B = 1024 elements cycling
     SS / STATIC / mFSC / FSC) with every element valid and each
     technique's t_par within rtol 1e-12, atol 1e-9 of the scalar engine
     (cold and warm seconds, and the scalar engine's seconds a
     simulation; that call alone profiled); one
     ``benchmarks/fig4_resilience.py`` Monte-Carlo cell
     per k in {1, 16, 31} (P = 32, N = 256, h = 1e-4, SS / mFSC / FSC,
     10,000 paired fail-stop draws each, 30,000 elements in one call):
     invalid elements re-run on the scalar engine and counted, 32 draws
     a technique equal to the scalar engine (t_par within 1e-9, counters
     exactly), the whole batch equal to the same call on the CPU, seconds
     a cell; and an adaptive virtual run (mFSC, P = 64, N = 8,192,
     DEVICE_PORTFOLIO, a decision every 8 reports) with device_sweep on
     and off: the same decisions, predictions within 1e-7, and at least
     one forecast batch on the card (counts set to 0 just before, read
     just after);
  8. process mode (``repro_torch.cluster``): P = 4 worker processes,
     each a spawned interpreter with its own CUDA context, the kernels
     built once by this process before it spawns them; kills and
     freezes are real signals.  Mandelbrot (FAC over the 64 tiles) with
     3 children SIGKILLed mid-run, and PSIA (FAC over the 20,000 points)
     with one, equal phase 3's image and spin images bit for bit, every
     task committed exactly once; olmo-1b at full width and depth in
     bfloat16 serves phase 4's 16 requests failure-free and through a
     SIGKILL and a SIGSTOP, tokens equal across the two and a threaded
     run; olmo-1b at 4 layers (``PROC_TRAIN_DEPTH``: a task's gradients
     fit one 1 GiB frame) trains one step (8 x 2,048 tokens, 8 tasks)
     failure-free and through a SIGKILL, parameters equal bit for bit
     to each other and to a threaded step.  Every child that ran a task
     reports its kernel path and launches (``cuda``, > 0 at the app's or
     the model's sites; the ``launches_process`` entries of the kernel
     rows); each run prints its wall seconds, seconds from spawn to
     first assignment per child, duplicates, wasted tasks, survivors,
     peak memory per child and of the card, payload bytes and chaos
     events; afterwards no child is left and the card's memory is back
     at its level before the phase;
  9. the serving executor's other paths: olmo-1b at full width and
     depth in bfloat16 with seeded weights serves 5 requests (prompts of
     37, 37, 64, 37 and 37 tokens, 16 new tokens) through GSS over P = 4
     threads in each of the four (``batch_decode``, ``fused_decode``)
     modes, once failure-free and once with worker 1 fail-stopping
     holding its first chunk: tokens equal bit for bit within a mode, at
     least one duplicate; launch and model-call counts set to 0 just
     before each run and read just after, each layer launching
     flash_attention once a prefill call and flash_decode once a decode
     step, the per-token loop modes calling no prefill; each run's wall
     seconds, requests/s and duplicates.  The legacy keywords (each
     construction warns): a concurrent SS run over 3 workers with a
     straggler and a fail-stop (not hung, the worker dead, the tokens of
     the mode that decodes each request alone), the hang without rDLB,
     and ``fail_worker(2)`` (worker 2 takes nothing, tokens unchanged).
     float32 copies of olmo-1b and rwkv6-1.6b at 2 layers, full width
     (3 requests, GSS over 2 threads): the four modes give the same
     greedy tokens through the kernels, rwkv6's per-token loop
     launching wkv6_decode and no wkv6_batched, and its fused modes,
     which prefill in segments replayed from kept CUDA graphs, launching
     wkv6_batched once a layer a segment;
 10. print one JSON line with the simulator's numbers (``{"devicesim":
     ...}``), one with each kernel's launches, error, times and bound,
     then the result line.

Exits non-zero, printing no result, when no GPU is present or when the
script is run outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12          # dense tensor-core rate
PEAK_BYTES = 3.35e12
# FP32 operations per Mandelbrot iteration (3 mul, 3 add/sub, 1 compare,
# 1 FMA counted as 2) and per spin-image point-center pair (3 sub,
# 6 mul + 4 add for beta and r2, beta^2, sub, max, sqrt, 2 div, 2 mul,
# 1 add, 2 floor, plus the 4 range compares left uncounted).
OPS_PER_ITER = 9
OPS_PER_PAIR = 24

# The image, iteration cap, PSIA points and cloud are the paper's
# (Table 1), read from the apps' own constants.  A Mandelbrot task is one
# TILE x TILE tile; the PSIA run (FAC over PSIA_WORKERS workers) launches
# spin_image at each chunk size of fac_chunk_sizes().  SPIN_CHUNK centers
# are the spin_image row of the {"kernels"} line, the shape earlier PRs
# timed.
TILE = 64
SPIN_CHUNK = 2048
PSIA_WORKERS = 4
# The FP32 dependent chain of one Mandelbrot iteration: zr -> zr*zr ->
# - zi*zi -> + cr, three operations of about 4 cycles each on Hopper.
CHAIN_CYCLES = 12

# Serving (phase 4): olmo-1b carries flash_decode, rwkv6-1.6b the two
# wkv6 kernels.  Prompt lengths cycle over SERVE_PROMPTS.
SERVE_ARCHS = ("olmo-1b", "rwkv6-1.6b")
# Phases 4 and 5 run these two at full width and half depth (of 16 and
# 24 layers), to keep the script near 600 s with phase 6; the float32
# check copies keep their 2 layers.
EARLIER_DEPTH = {"olmo-1b": 8, "rwkv6-1.6b": 12}
SERVE_PROMPTS = (37, 64, 1000)
SERVE_REQUESTS = 16
SERVE_NEW = 16
# Decode throughput: FusedGenerator at (B, S, new tokens); the profiled
# call generates PROFILED_NEW tokens.
THROUGHPUT = (8, 64, 64)
PROFILED_NEW = 8
# FP32 operations: per (query row, valid slot) of flash_decode, 2 D for
# the score, 2 Dv for the accumulator, 4 for max, two exps and the sum;
# per state element of a wkv6_decode step, 7 (y: k*v, u*kv, +S, *r, +;
# S': w*S + kv).


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def call_ms(fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn`` from the host, back to back: CUDA
    events around ``reps`` warm calls.  For a short kernel this is the
    wrapper's launch rate, not the kernel's time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds per call: ``reps`` calls captured in one CUDA
    graph and replayed, so that no host work sits between the launches
    (CUDA events around three replays)."""
    import torch
    warm = torch.cuda.Stream()
    warm.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(warm):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(warm)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (3 * reps)


def trace_ms(fn, kernel: str, reps: int) -> float | None:
    """Device milliseconds per launch of the CUDA function named
    ``kernel``, as a torch.profiler trace of ``reps`` calls records it;
    None when the trace holds no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if kernel in ev.key and ev.count:
            us = device_us(ev)
            return us / ev.count / 1e3 if us else None
    return None


def device_events(prof, averages=None) -> list:
    """The profiler's per-kernel averages that ran on the card, from
    ``averages`` (``prof.key_averages()``, which takes seconds to build
    on a long trace) when the caller has them."""
    if averages is None:
        averages = prof.key_averages()
    return [e for e in averages if e.count and
            str(getattr(e, "device_type", "")).endswith("CUDA")]


def device_us(e) -> float:
    return (getattr(e, "self_device_time_total", 0)
            or getattr(e, "self_cuda_time_total", 0))


def bound_ms(n_bytes: float, n_ops: float,
             peak: float = PEAK_FP32) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ phase 2
def fac_chunk_sizes(n: int, p: int) -> list:
    """The chunk sizes FAC hands out over n tasks and p workers, in order
    (the batching rule of ``core/dls.py``): the spin_image launches of
    the PSIA run."""
    from repro_torch.core.dls import make_technique
    tech = make_technique("FAC", n, p)
    sizes, left = [], n
    while left > 0:
        c = tech.next_chunk(0, left)
        sizes.append(c)
        left -= c
    return sizes


def sm_clock_mhz() -> float:
    """The card's maximum SM clock (``nvidia-smi``), for the chain floor."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return float(res.stdout.split()[0])


def compare_mandelbrot(dev, *, every_tile: bool = False) -> dict:
    """mandelbrot against its plain version, exactly: the whole image
    (twice: the second launch must repeat the first bit for bit) and each
    of its 64 tiles as strided views of the grid, as ``compute_tile``
    launches them; then timed beside its bound: the image, the deepest
    and the lightest tile alone (every tile with ``every_tile``), and the
    64 tiles in turn, each tile printed with its dependent-chain floor."""
    import torch
    from repro_torch.apps import mandelbrot
    from repro_torch.kernels import mandelbrot as km
    side, iters = mandelbrot.SIDE, mandelbrot.MAX_ITERS
    cr, ci = mandelbrot.grid(side, device=dev)
    got = km.mandelbrot(cr, ci, max_iters=iters)
    want = km.mandelbrot_plain(cr, ci, iters)
    n_diff = int((got != want).sum())
    err = float((got - want).abs().max())
    if not torch.equal(km.mandelbrot(cr, ci, max_iters=iters), got):
        fail("mandelbrot: a second launch differs from the first")
    per_row = side // TILE
    tiles, tile_diff = [], 0
    for t in range(per_row * per_row):
        ty, tx = divmod(t, per_row)
        sl = (slice(ty * TILE, (ty + 1) * TILE),
              slice(tx * TILE, (tx + 1) * TILE))
        a, b = cr[sl], ci[sl]
        w = km.mandelbrot_plain(a, b, iters)
        tile_diff += int((km.mandelbrot(a, b, max_iters=iters) != w).sum())
        tiles.append((t, a, b, int(w.sum()), int(w.max())))
    print(f"compare,mandelbrot,{side}x{side}/{iters} (twice) and "
          f"{len(tiles)} tiles of {TILE}x{TILE} as strided views,"
          f"differing_pixels={n_diff + tile_diff},max_abs_err={err}")
    if n_diff or tile_diff:
        fail(f"mandelbrot kernel differs from its plain version in "
             f"{n_diff} + {tile_diff} pixels")
    b_ms, by = bound_ms(3 * side * side * 4, OPS_PER_ITER * int(want.sum()))
    row = dict(name="mandelbrot", route="cuda",
               source="src/repro_torch/csrc/mandelbrot.cu",
               replaces="src/repro/kernels/mandelbrot.py:49",
               shape=f"({side},{side}) max_iters={iters}",
               max_abs_err=err, bound_ms=b_ms, bound_by=by, library_ms=None)
    launch = lambda: km.mandelbrot(cr, ci, max_iters=iters)  # noqa: E731
    row.update(ms=graph_ms(launch, 200),
               trace_ms=trace_ms(launch, "mandelbrot_kernel", 200),
               call_ms=call_ms(launch, 200),
               plain_ms=call_ms(lambda: km.mandelbrot_plain(cr, ci, iters),
                                3, warmup=1))
    print(f"mandelbrot,timed {side}x{side},ms={row['ms']},"
          f"bound_ms={b_ms} ({by})")
    clock = sm_clock_mhz()
    deepest = max(tiles, key=lambda t: t[3])[0]
    lightest = min(tiles, key=lambda t: t[3])[0]
    shapes = []
    for t, a, b, n_it, top in tiles:
        if not (every_tile or t in (deepest, lightest)):
            continue
        t_ms, t_by = bound_ms(3 * TILE * TILE * 4, OPS_PER_ITER * n_it)
        floor = top * CHAIN_CYCLES / (clock * 1e3)
        ms = graph_ms(lambda a=a, b=b: km.mandelbrot(a, b, max_iters=iters),
                      100)
        shapes.append(dict(shape=f"tile {t} ({TILE}x{TILE})", ms=ms,
                           bound_ms=t_ms, bound_by=t_by))
        print(f"mandelbrot,timed tile {t},iterations={n_it},deepest={top},"
              f"ms={ms},bound_ms={t_ms} ({t_by}),chain_floor_ms={floor} "
              f"(at {clock:.0f} MHz)")
    ms = graph_ms(lambda: [km.mandelbrot(a, b, max_iters=iters)
                           for _, a, b, _, _ in tiles], 10)
    t_ms, t_by = bound_ms(3 * side * side * 4, OPS_PER_ITER * int(want.sum()))
    shapes.append(dict(shape=f"{len(tiles)} tiles in turn", ms=ms,
                       bound_ms=t_ms, bound_by=t_by))
    print(f"mandelbrot,timed {len(tiles)} tiles in turn,ms={ms},"
          f"bound_ms={t_ms} ({t_by})")
    row["shapes"] = shapes
    return row


def compare_spin_image(dev) -> dict:
    """spin_image against its plain version, exactly: at every chunk size
    FAC gives the PSIA run and at SPIN_CHUNK centers, each launched twice
    (the same bits), on a cloud one point short (no split divides it),
    on a cloud 12 bytes off 16-byte alignment (the kernel's element
    loads) and on points placed on bin edges; then each chunk size timed
    beside its bound."""
    import torch
    from repro_torch.apps import psia
    from repro_torch.kernels import spin_image as ks
    data = psia.dataset(n=psia.PAPER_N, cloud_n=psia.CLOUD, device=dev)
    pts = data.points
    kw = dict(n_alpha=psia.N_ALPHA, n_beta=psia.N_BETA,
              alpha_max=psia.ALPHA_MAX, beta_max=psia.BETA_MAX)
    sizes = fac_chunk_sizes(psia.PAPER_N, PSIA_WORKERS)
    err, n_diff, checked = 0.0, 0, []
    # the same cloud one point into a buffer: 12 bytes off alignment
    buf = torch.empty((pts.shape[0] + 1, 3), dtype=pts.dtype, device=dev)
    buf[1:] = pts
    unaligned = buf[1:]

    def check(label, p, c, n):
        nonlocal err, n_diff
        got = ks.spin_image(p, c, n, **kw)
        want = ks.spin_image_plain(p, c, n, **kw)
        if not torch.equal(ks.spin_image(p, c, n, **kw), got):
            fail(f"spin_image ({label}): a second launch differs from the "
                 f"first")
        n_diff += int((got != want).sum())
        err = max(err, float((got - want).abs().max()))
        checked.append(label)
        return got, want

    timed, est = [], 0.0
    for n in sorted(set(sizes) | {SPIN_CHUNK}, reverse=True):
        ctr = data.centers[:n].contiguous()
        nrm = data.normals[:n].contiguous()
        got, want = check(f"{n}x{pts.shape[0]}", pts, ctr, nrm)
        if n in (1, 39, 157, 2500):
            check(f"{n}x{pts.shape[0] - 1}", pts[:-1], ctr, nrm)
        if n in (1, 39, 2500):
            check(f"{n}x{pts.shape[0]} unaligned", unaligned, ctr, nrm)
        n_bytes = (pts.numel() + ctr.numel() + nrm.numel()
                   + got.numel()) * 4
        b, by = bound_ms(n_bytes, OPS_PER_PAIR * n * pts.shape[0])
        launch = lambda: ks.spin_image(pts, ctr, nrm, **kw)  # noqa: E731
        ms = graph_ms(launch, 20 if n > 1000 else 100)
        timed.append(dict(shape=f"centers={n} points={pts.shape[0]}",
                          ms=ms, bound_ms=b, bound_by=by))
        est += ms * sizes.count(n)
        print(f"spin_image,timed centers={n},points={pts.shape[0]},"
              f"split={ks.pt_split(n, pts.shape[0])},"
              f"chunks_per_run={sizes.count(n)},ms={ms},"
              f"bound_ms={b} ({by})")
        if n == SPIN_CHUNK:
            row = dict(name="spin_image", route="cuda",
                       source="src/repro_torch/csrc/spin_image.cu",
                       replaces="src/repro/kernels/spin_image.py:71",
                       shape=f"centers={n} points={pts.shape[0]} "
                             f"bins={psia.N_BETA}x{psia.N_ALPHA}",
                       bound_ms=b, bound_by=by, library_ms=None)
            row.update(ms=ms, trace_ms=trace_ms(launch, "spin_image_kernel",
                                                50),
                       call_ms=call_ms(launch, 50),
                       plain_ms=call_ms(lambda: ks.spin_image_plain(
                           pts, ctr, nrm, **kw), 3, warmup=1))
    p, c, n = (x.to(dev) for x in ks.bin_edge_cloud(**kw))
    for n_centers in (1, 8):
        check(f"bin edges, {n_centers}x{p.shape[0]}", p,
              c.expand(n_centers, 3).contiguous(),
              n.expand(n_centers, 3).contiguous())
    print(f"compare,spin_image,{len(checked)} cases ({'; '.join(checked)}),"
          f"differing_bins={n_diff},max_abs_err={err}")
    if n_diff:
        fail(f"spin_image kernel differs from its plain version in "
             f"{n_diff} bins")
    print(f"spin_image,the run's {len(sizes)} FAC chunks timed alone: "
          f"sum ms={est}")
    row.update(max_abs_err=err, shapes=timed)
    return row


def guard_share(dev) -> None:
    """Share of the PSIA run's pairs (every center over the cloud) that
    the fast binning's guard sends to the correctly rounded chain, from
    its plain mirror with PyTorch's rsqrt on the card (printed; not a
    measurement of the kernel); the mirror's bins must equal the plain
    version's."""
    import torch
    from repro_torch.apps import psia
    from repro_torch.kernels import spin_image as ks
    data = psia.dataset(n=psia.PAPER_N, cloud_n=psia.CLOUD, device=dev)
    kw = dict(n_alpha=psia.N_ALPHA, n_beta=psia.N_BETA,
              alpha_max=psia.ALPHA_MAX, beta_max=psia.BETA_MAX)
    slow = 0
    for c0 in range(0, psia.PAPER_N, 2500):
        ctr, nrm = (x[c0:c0 + 2500] for x in (data.centers, data.normals))
        hist, n = ks.spin_image_guard_mirror(data.points, ctr, nrm, **kw)
        if not torch.equal(hist, ks.spin_image_plain(data.points, ctr, nrm,
                                                     **kw)):
            fail("spin_image's guard mirror differs from the plain version")
        slow += n
    pairs = psia.PAPER_N * psia.CLOUD
    print(f"guard,spin_image,pairs={pairs},slow_path_pairs={slow},"
          f"share={slow / pairs}")


def compare_kernels(dev) -> dict:
    """The paper path's two kernels against their plain versions on
    ``dev``, at the shapes the rDLB runs launch, and timed; returns the
    per-kernel report rows."""
    rows = {"mandelbrot": compare_mandelbrot(dev),
            "spin_image": compare_spin_image(dev)}
    guard_share(dev)
    return rows


# ------------------------------------------------------------ phase 3
def _cluster(failing, fail_after):
    """P=4; worker ``failing`` (None: nobody) fail-stops after
    ``fail_after`` tasks, at its next assignment, holding that chunk."""
    from repro_torch import api
    return api.ClusterSpec(n_workers=4, workers=tuple(
        api.WorkerSpec(fail_after_tasks=fail_after if w == failing
                       else None) for w in range(4)))


def run_mandelbrot(dev, *, failing):
    """Threaded rDLB (SS, P=4) over the image's tiles -> (image, stats)."""
    from repro_torch import api
    from repro_torch.apps import mandelbrot
    from repro_torch.runtime import FnBackend
    side, max_iters = mandelbrot.SIDE, mandelbrot.MAX_ITERS
    n = mandelbrot.n_tiles(side, TILE)
    spec = api.RunSpec(scheduling=api.SchedulingSpec(technique="SS"),
                       cluster=_cluster(failing, 2),
                       execution=api.ExecutionSpec(mode="threaded"),
                       n_tasks=n, name="mandelbrot")
    backend = FnBackend(task_fn=lambda t: mandelbrot.compute_tile(
        t, side=side, tile=TILE, max_iters=max_iters, device=dev))
    st = api.execute(spec, backend)
    if st.hung or st.n_finished != n:
        fail(f"mandelbrot rDLB run finished {st.n_finished}/{n} tiles")
    img = mandelbrot.assemble(backend.results, side=side, tile=TILE)
    return img, st


def psia_backend(data):
    """Engine backend: a chunk is a run of oriented points, computed as
    one spin-image batch; each point's image is kept exactly once."""
    from repro_torch.apps import psia
    from repro_torch.core.engine import WorkerBackend

    class PsiaBackend(WorkerBackend):
        def __init__(self):
            self.results = {}

        def execute(self, chunk, wid):
            return psia.compute_tasks(chunk.tasks(), data=data)

        def commit(self, chunk, wid, payload, newly):
            for t in newly:
                self.results[t] = payload[t - chunk.start]

    return PsiaBackend()


def run_psia(dev, *, failing):
    """Threaded rDLB (FAC, P=4) over all oriented points ->
    (spin images (n, n_beta, n_alpha), stats)."""
    import numpy as np
    from repro_torch import api
    from repro_torch.apps import psia
    n = psia.PAPER_N
    backend = psia_backend(psia.dataset(n=n, cloud_n=psia.CLOUD,
                                        device=dev))
    spec = api.RunSpec(scheduling=api.SchedulingSpec(technique="FAC"),
                       cluster=_cluster(failing, 1),
                       execution=api.ExecutionSpec(mode="threaded"),
                       n_tasks=n, name="psia")
    st = api.execute(spec, backend)
    if st.hung or st.n_finished != n or len(backend.results) != n:
        fail(f"psia rDLB run finished {st.n_finished}/{n} points")
    return np.stack([backend.results[t] for t in range(n)]), st


def drive_main_path(dev) -> dict:
    """The two fail-stop runs, with the launch counts set to 0 just
    before and read (with the path each site took) just after."""
    from repro_torch.kernels import dispatch
    dispatch.reset_launches()
    t0 = time.perf_counter()
    img, mst = run_mandelbrot(dev, failing=2)
    t1 = time.perf_counter()
    spins, pst = run_psia(dev, failing=1)
    t2 = time.perf_counter()
    return dict(img=img, mst=mst, t_m=t1 - t0, spins=spins, pst=pst,
                t_p=t2 - t1, launches=dispatch.launches(),
                status=dispatch.status())


def profile_app_run(dev, app: str) -> dict:
    """One failure-free rDLB run of ``app`` ("mandelbrot" or "psia") as
    phase 3 drives it, after a warm one: its wall seconds and the app
    kernel's launches unprofiled, then traced with torch.profiler: the
    kernel's device ms summed over the run (kernel ms per run) and its
    calls, all device time and calls, and the kernels that take most."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import dispatch
    run = run_mandelbrot if app == "mandelbrot" else run_psia
    site = "mandelbrot" if app == "mandelbrot" else "spin_image"
    run(dev, failing=None)
    torch.cuda.synchronize()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    run(dev, failing=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dispatch.launches(site)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(dev, failing=None)
        torch.cuda.synchronize()
    kernels = sorted(((e.key[:70], e.count, device_us(e) / 1e3)
                      for e in device_events(prof)), key=lambda k: -k[2])
    mine = [k for k in kernels if site in k[0]]
    out = dict(app=app, wall_s=wall, launches=launches,
               kernel_ms_per_run=sum(k[2] for k in mine),
               kernel_calls=sum(k[1] for k in mine),
               device_ms_per_run=sum(k[2] for k in kernels),
               device_calls=sum(k[1] for k in kernels),
               top=[(n, c, round(ms, 4)) for n, c, ms in kernels[:6]])
    print(f"run,{app},failure-free,wall_s={wall:.4f},launches={launches},"
          f"kernel_ms_per_run={out['kernel_ms_per_run']},kernel_calls="
          f"{out['kernel_calls']},device_ms_per_run="
          f"{out['device_ms_per_run']},device_calls={out['device_calls']},"
          f"top (name, calls, ms)={out['top']}")
    return out


def check_main_path(dev, run: dict) -> None:
    """Fail-stop results against failure-free runs (bit for bit) and,
    for a few tiles and spin images, against the CPU plain path."""
    import numpy as np
    from repro_torch.apps import mandelbrot, psia
    from repro_torch.kernels import ref
    img, spins = run["img"], run["spins"]
    side, max_iters, n = mandelbrot.SIDE, mandelbrot.MAX_ITERS, psia.PAPER_N
    for name, st in (("mandelbrot", run["mst"]), ("psia", run["pst"])):
        if st.n_duplicates <= 0:
            fail(f"{name}: the fail-stop run issued no rDLB duplicate")
    clean, _ = run_mandelbrot(dev, failing=None)
    whole = mandelbrot.escape_counts(side, max_iters, device=dev)
    if not (np.array_equal(img, clean) and np.array_equal(img, whole)):
        fail("mandelbrot image under a fail-stop differs from the "
             "failure-free render")
    cr, ci = mandelbrot.grid(side, device="cpu")
    per_row = side // TILE
    for tid in (0, per_row * per_row // 2 - 1, per_row * per_row - 1):
        ty, tx = divmod(tid, per_row)
        sl = (slice(ty * TILE, (ty + 1) * TILE),
              slice(tx * TILE, (tx + 1) * TILE))
        cpu = ref.mandelbrot(cr[sl].contiguous(), ci[sl].contiguous(),
                             max_iters).numpy()
        if not np.array_equal(img[sl], cpu):
            fail(f"mandelbrot tile {tid} differs from the CPU plain path")
    clean_spins, _ = run_psia(dev, failing=None)
    if not np.array_equal(spins, clean_spins):
        n_bad = int((spins != clean_spins).any(axis=(1, 2)).sum())
        fail(f"{n_bad} spin images under a fail-stop differ from the "
             f"failure-free run")
    ids = [0, n // 2 + 1, n - 1]
    cpu = psia.compute_tasks(ids, n=n, cloud_n=psia.CLOUD, device="cpu")
    if not np.array_equal(spins[ids], cpu):
        fail("spin images differ from the CPU plain path")
    if spins.shape != (n, psia.N_BETA, psia.N_ALPHA) or not (
            np.isfinite(spins).all()):
        fail(f"spin images malformed: shape {spins.shape}")


# ------------------------------------------------------- phase 2, decode
def flash_decode_ops(rows: int, n_valid: int, D: int, Dv: int) -> float:
    return rows * n_valid * (2 * D + 2 * Dv + 4)


def wkv6_batched_ops(BH: int, T: int, dk: int, dv: int,
                     chunk: int) -> float:
    """FP32 operations of the chunked form (csrc/wkv6.cu) over T steps:
    per chunk of c rows, the log and cumulative sum (2 c dk), the pairwise
    scores (c(c-1)/2 dk x 5: sub, exp, two muls, add), the u bonus
    (3 c dk), r and k under decay (5 c dk), y (c(c+1) dv + 2 c dk dv) and
    the carried state (dk dv (2 c + 1))."""
    ops = 0
    for t0 in range(0, T, chunk):
        c = min(chunk, T - t0)
        ops += (2 * c * dk + c * (c - 1) // 2 * dk * 5 + 3 * c * dk
                + 5 * c * dk + c * (c + 1) * dv + 2 * c * dk * dv
                + dk * dv * (2 * c + 1))
    return BH * ops


def _report(rows, name, **kw):
    rows[name] = dict(name=name, route="cuda", **kw)


def _time(rows, name, launch, plain, kernel_fn, reps, library=None):
    rows[name].update(
        ms=graph_ms(launch, reps), trace_ms=trace_ms(launch, kernel_fn, reps),
        call_ms=call_ms(launch, reps),
        plain_ms=call_ms(plain, 3, warmup=1),
        library_ms=None if library is None else call_ms(library, reps))


def compare_decode_kernels(dev) -> dict:
    """flash_decode, wkv6_decode and wkv6_batched against their plain
    versions on ``dev``, at the served models' full widths, and timed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import rwkv6_scan as kw

    rows = {}
    gen = torch.Generator().manual_seed(0)
    olmo, rwkv = get_config("olmo-1b"), get_config("rwkv6-1.6b")
    B = THROUGHPUT[0]
    H, D = olmo.n_heads, olmo.head_dim
    R = B * H                                  # query rows after folding

    # flash_decode: folded layout in both dtypes, and the cache layout the
    # serving path passes (bf16), at a ragged and a full block length.
    # float32 within 1e-5; bfloat16 within one rounding of the output,
    # 1e-4 + 2**-7 * |plain| per element.
    tol = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-4, 2.0 ** -7)}

    def check(name, shape, dtype, got, want):
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        atol, rtol = tol[dtype]
        e = float(diff.max())
        print(f"compare,{name},{shape},{dtype},max_abs_err={e},"
              f"tolerance={atol}+{rtol}*|plain|")
        if not bool((diff <= atol + rtol * want.abs()).all()):
            fail(f"{name} differs from its plain version by up to {e}")
        return e

    err = 0.0
    # 8 CTAs per row at L = 1016 and 1024 (at 1024 the second split is
    # masked whole), 1 at 100, 3 at 300
    for L in (1016, 1024, 100, 300):
        valid = torch.rand(L, generator=gen) < 0.6
        valid[128:256] = False                 # fully masked blocks
        valid[L - 64:] = False
        valid = valid.to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((R, D), generator=gen).to(dev, dtype)
            k = torch.randn((R, L, D), generator=gen).to(dev, dtype)
            v = torch.randn((R, L, D), generator=gen).to(dev, dtype)
            err = max(err, check(
                "flash_decode", f"rows={R},L={L},D={D},"
                f"valid={int(valid.sum())},cluster={kf.decode_splits(L)}",
                dtype,
                kf.flash_decode(q, k, v, valid),
                kf.flash_decode_plain(q, k, v, valid)))
        qc = torch.randn((B, H, D), generator=gen).to(dev, torch.bfloat16)
        kc, vc = (torch.randn((B, L, H, D), generator=gen).to(
            dev, torch.bfloat16) for _ in range(2))
        err = max(err, check(
            "flash_decode_gqa", f"cache=({B};{L};{H};{D})", torch.bfloat16,
            kf.flash_decode_gqa(qc, kc, vc, valid),
            kf.flash_decode_gqa_plain(qc, kc, vc, valid)))
    # timed: the serving path's largest step, olmo-1b's cache after a
    # 1000-token prompt and 15 new tokens (L = 1016, every slot valid)
    L = SERVE_PROMPTS[-1] + SERVE_NEW
    valid = torch.ones(L, dtype=torch.bool, device=dev)
    qc = torch.randn((B, H, D), generator=gen).to(dev, torch.bfloat16)
    kc, vc = (torch.randn((B, L, H, D), generator=gen).to(
        dev, torch.bfloat16) for _ in range(2))
    n_bytes = 2 * (qc.numel() + kc.numel() + vc.numel() + B * H * D) + L
    b, by = bound_ms(n_bytes, flash_decode_ops(R, L, D, D))
    _report(rows, "flash_decode",
            source="src/repro_torch/csrc/flash_decode.cu",
            replaces="src/repro/kernels/flash_attention.py:111",
            shape=f"cache ({B},{L},{H},{D}) bf16, {R} query rows, "
                  f"all slots valid",
            max_abs_err=err, bound_ms=b, bound_by=by)
    qs = qc.reshape(R, 1, D)
    ks = kc.transpose(1, 2).reshape(R, L, D)
    vs = vc.transpose(1, 2).reshape(R, L, D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    _time(rows, "flash_decode",
          lambda: kf.flash_decode_gqa(qc, kc, vc, valid),
          lambda: kf.flash_decode_gqa_plain(qc, kc, vc, valid),
          "flash_decode_kernel", 100,
          library=lambda: sdpa(qs, ks, vs, attn_mask=valid[None, :]))
    print(f"flash_decode,timed L={L},cluster={kf.decode_splits(L)} CTAs "
          f"per row,ms={rows['flash_decode']['ms']}")
    # and the short cache of a 64-token prompt's last step: one CTA a row
    Ls = SERVE_PROMPTS[1] + SERVE_NEW
    ks_, vs_ = kc[:, :Ls].contiguous(), vc[:, :Ls].contiguous()
    ok_ = valid[:Ls].contiguous()
    short = graph_ms(lambda: kf.flash_decode_gqa(qc, ks_, vs_, ok_), 100)
    print(f"flash_decode,timed L={Ls},cluster={kf.decode_splits(Ls)} CTAs "
          f"per row,ms={short}")
    # the serving path's own shape: one request a group (B = 1), its H
    # query rows against the cache each served prompt reaches at its last
    # step (L = 53, 80, 1016; every slot valid but the last, which the
    # last new token never fills), held, timed and beside SDPA
    shapes = [decode_shape(dev, f"olmo-1b, {p}-token prompt", H, H, D,
                           served_valid(p + SERVE_NEW, p), gen)
              for p in SERVE_PROMPTS]
    err = max([err] + [r["max_abs_err"] for r in shapes])
    rows["flash_decode"].update(max_abs_err=err, shapes=shapes)

    rows.update(compare_wkv6_kernels(dev))
    return rows


# The dropless MoE kernels (moe_route, and moe_gemm's gate-up and down
# products) at the shapes the deepseek-v2-lite-16b.prefill-failstop cell
# launches: DeepSeek-V2-Lite's widths (E 64, k 6, d 2048, f 1408) and
# its published routing (MOE_CONFIG, the benchmark's configuration file),
# at prompts of 256, 1024 and 2040 tokens (the prefill mix's range: the
# tile variant) and at decode steps of 1 and 4 tokens (small_m).  Inputs
# drawn from a seed: x ~ N(0, 1), logits 2 N(0, 1) (uneven, no expert
# takes most rows), weights N(0, 1 / fan-in), bf16.  Routing equals the
# plain version exactly (experts, counts), gates within 1e-6; the layer's
# output within MOE_TOL of its largest magnitude (float32 sums in other
# orders, and the hidden row rounded to bf16 between the products: one
# bf16 rounding step, 2^-8, carried through W_down).
MOE_CONFIG = os.path.join(ROOT, "portbench", "configs",
                          "deepseek-v2-lite-16b.json")
MOE_TOKENS = (1, 4, 256, 1024, 2040)
MOE_ROW_TOKENS = 1024            # the moe rows of the {"kernels"} line
MOE_TOL = 2 ** -7


def published_deepseek():
    """DeepSeek-V2-Lite as the benchmark serves it: the ``model`` block of
    MOE_CONFIG (published routing, YaRN)."""
    from repro_torch.models.config import ModelConfig
    with open(MOE_CONFIG) as f:
        return ModelConfig.from_reference(json.load(f)["model"])


def moe_gemm_bound(T: int, K: int, touched: int, D: int, Fh: int):
    """(bound_ms, by) of a layer's two grouped products: the touched
    experts' weights read once, x's rows read, the hidden rows written
    and read in bf16, the routed rows written in float32; against
    2 x 3 x d x f operations a routed row at the bf16 peak."""
    n_bytes = (touched * 3 * D * Fh * 2 + T * D * 2 + 2 * T * K * Fh * 2
               + T * K * D * 4)
    return bound_ms(n_bytes, 2 * 3 * D * Fh * T * K, peak=PEAK_BF16)


def moe_kernel_ms(fn, reps: int) -> dict:
    """Device ms per launch of each moe kernel over ``reps`` calls of
    ``fn``, as a profiler trace records them: {"route", "gate_up",
    "down"}; a kernel the trace holds no time for is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in device_events(prof):
        key = ev.key
        part = ("route" if "moe_route_kernel" in key else
                "gate_up" if "moe_gemm_kernel" in key and "true" in key else
                "down" if "moe_gemm_kernel" in key else None)
        if part and device_us(ev):
            out[part] = out.get(part, 0.0) + device_us(ev) / ev.count / 1e3
    return out


def compare_moe_kernels(dev) -> dict:
    """moe_route and moe_gemm against route_plain, schedule_plain and
    experts_plain on the same card tensors at MOE_TOKENS, and timed
    beside their bound; returns the two rows of the report."""
    import torch
    from repro_torch.kernels import moe as km
    cfg = published_deepseek()
    E, K, D, Fh = (cfg.n_routed_experts, cfg.top_k, cfg.d_model,
                   cfg.d_expert)
    gen = torch.Generator(device=dev).manual_seed(11)
    w = [(torch.randn(E, a, b, generator=gen, device=dev) / a ** 0.5)
         .to(torch.bfloat16) for a, b in ((D, Fh), (D, Fh), (Fh, D))]
    rows = {"moe_route": dict(name="moe_route", route="cuda", shapes=[]),
            "moe_gemm": dict(name="moe_gemm", route="cuda", shapes=[])}
    for T in MOE_TOKENS:
        x = torch.randn(T, D, generator=gen, device=dev).to(torch.bfloat16)
        logits = 2.0 * torch.randn(T, E, generator=gen, device=dev)
        counter = torch.zeros(E, dtype=torch.int64, device=dev)

        def launch(c=counter):
            return km.routed_experts(
                x, logits, *w, top_k=K, norm_topk=cfg.norm_topk_prob,
                scale=cfg.routed_scaling_factor, counter=c)
        with torch.inference_mode():
            out, idx, gates = launch()
            p_idx, p_gates = km.route_plain(logits, K, cfg.norm_topk_prob,
                                            cfg.routed_scaling_factor)
            want = km.experts_plain(x, p_idx, p_gates, *w)
        torch.cuda.synchronize()
        var = km.variant(T)
        sch = km.schedule_plain(p_idx.cpu(), E, km.BM[var])
        counts = counter.cpu()
        gate_err = float((gates - p_gates).abs().max())
        err = float((out - want).abs().max())
        scale = float(want.abs().max())
        if not torch.equal(idx.long(), p_idx):
            fail(f"moe_route at T={T}: experts differ from route_plain")
        if not torch.equal(counts, sch["counts"]):
            fail(f"moe_route at T={T}: row counts differ from "
                 f"schedule_plain")
        if gate_err > 1e-6:
            fail(f"moe_route at T={T}: gates off by {gate_err}")
        if not err <= MOE_TOL * scale:
            fail(f"moe_gemm at T={T}: max_abs_err={err} over "
                 f"{MOE_TOL} x {scale}")
        touched = int((counts > 0).sum())
        spare = torch.zeros_like(counter)
        with torch.inference_mode():
            parts = moe_kernel_ms(lambda: launch(spare), 10)
            ms = graph_ms(lambda: launch(spare), 10)
        b, by = moe_gemm_bound(T, K, touched, D, Fh)
        gemm_ms = (parts.get("gate_up", 0.0) + parts.get("down", 0.0)
                   or None)
        shape = dict(T=T, variant=var, touched=touched,
                     max_rows=int(counts.max()), max_abs_err=err,
                     out_scale=scale, gate_err=gate_err, layer_ms=ms,
                     **parts, gemm_ms=gemm_ms, bound_ms=b, bound_by=by)
        rows["moe_gemm"]["shapes"].append(shape)
        rows["moe_route"]["shapes"].append(dict(T=T, ms=parts.get("route")))
        print(f"compare,moe,T={T},{var},touched={touched},max_rows="
              f"{shape['max_rows']},max_abs_err={err} (tol {MOE_TOL} x "
              f"{scale}),gate_err={gate_err},route_ms={parts.get('route')},"
              f"gate_up_ms={parts.get('gate_up')},down_ms="
              f"{parts.get('down')},layer_ms={ms},bound_ms={b} ({by}),"
              f"bound_share={b / gemm_ms if gemm_ms else None}")
        if T == MOE_ROW_TOKENS:
            rows["moe_gemm"].update(ms=gemm_ms, bound_ms=b, bound_by=by,
                                    max_abs_err=err)
            rows["moe_route"].update(ms=parts.get("route"))
    del w
    torch.cuda.empty_cache()
    return rows


# wkv6 shapes: rwkv6-1.6b's 32 heads of 64 at B = 1 (BH = 32: the serving
# path decodes each request on its own, one prompt length per group) and
# at B = 8 (BH = 256: FusedGenerator's throughput shape); the batched
# kernel at the served prompt lengths, at T = 64, and at the lengths of a
# segmented prefill's segments (SEGMENT_SHORT and SEGMENT_LONG of
# runtime/serve_executor: every rwkv6 prefill on the card launches these).
WKV_DECODE_BH = (32, 256)
WKV_BATCHED = ((32, 37), (32, 64), (32, 1000), (256, 64), (32, 256),
               (32, 1024))
# A segmented prefill's padded last segment: (BH, T, real steps), k = 0
# and w = 1 past the real steps.  Where the padding fills whole chunks,
# the state and the real steps' y equal the unpadded launch's bit for
# bit; where a chunk holds both, the kernel sums that chunk's log decays
# in blocks set by its row count (32 padded, fewer unpadded), so the two
# agree to rounding (within the batched kernel's tolerance).
WKV_PADDED = ((32, 256, 192), (32, 256, 200), (32, 1024, 992),
              (32, 1024, 1000))
# The row of the {"kernels": [...]} line: the shape earlier PRs timed.
WKV_ROW = {"wkv6_decode": 256, "wkv6_batched": (256, 64)}



def wkv_inputs(dev, gen, BH, T, dk, dtype, *, w=None):
    """r, k, v, w, u in ``dtype`` and a float32 state; T = 0 gives one
    step's (BH, dk) inputs.  w as the model makes it (exp(-exp(x)) near
    e^-1), or the constant ``w``."""
    import torch
    lead = (BH, T) if T else (BH,)
    r, k, v = (torch.randn(lead + (dk,), generator=gen) for _ in range(3))
    ww = torch.exp(-torch.exp(torch.randn(lead + (dk,), generator=gen)
                              * 0.5 - 1.0))
    if w is not None:
        ww = torch.full_like(ww, w)
    u = torch.randn((BH, dk), generator=gen)
    s = torch.randn((BH, dk, dk), generator=gen)
    return [x.to(dev, dtype) for x in (r, k, v, ww, u)] + [s.to(dev)]


def wkv6_padding_gap(fn, ins, n: int) -> tuple:
    """``fn`` (wkv6_batched or its plain version) on ``ins`` = (r, k, v,
    w, u, state) of T steps with k = 0 and w = 1 from step n on, against
    ``fn`` on the first n steps alone -> (the largest difference of the
    state and of the n real steps' y, each as a share of the unpadded
    launch's largest magnitude; whether both are equal bit for bit)."""
    import torch
    r, k, v, w, u, s = ins
    k, w = k.clone(), w.clone()
    k[:, n:] = 0.0
    w[:, n:] = 1.0
    y_pad, s_pad = fn(r, k, v, w, u, s)
    y_pad = y_pad[:, :n]
    y, s_one = fn(*(x[:, :n].contiguous() for x in (r, k, v, w)), u, s)

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())
    return (rel(s_pad, s_one), rel(y_pad, y),
            torch.equal(s_pad, s_one) and torch.equal(y_pad, y))


def check_wkv6_padding(dev, gen) -> None:
    """wkv6_batched at each of WKV_PADDED: bit for bit where the padding
    fills whole chunks, within 1e-4 of the largest magnitude elsewhere."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import rwkv6_scan as kw
    import torch
    dk = get_config("rwkv6-1.6b").rwkv_head_dim
    for BH, T, n in WKV_PADDED:
        ins = wkv_inputs(dev, gen, BH, T, dk, torch.bfloat16)
        e_state, e_y, exact = wkv6_padding_gap(kw.wkv6_batched, ins, n)
        whole = n % kw.CHUNK == 0
        print(f"compare,wkv6_batched_padded,BH={BH},T={T},real={n},"
              f"whole_chunks={whole},state_rel_err={e_state},"
              f"y_rel_err={e_y},bit_equal={exact}")
        if not (exact if whole else max(e_state, e_y) <= 1e-4):
            fail(f"wkv6_batched (BH={BH}, T={T}) padded past {n} steps "
                 f"differs from the unpadded launch (state {e_state}, y "
                 f"{e_y}, bit equal {exact})")


def wkv6_decode_bound(BH: int, dk: int, dv: int) -> tuple[float, str]:
    """bf16 r, k, w, u and v read, the float32 state read and written, y
    written; 7 operations per state element."""
    n_bytes = 2 * (4 * BH * dk + BH * dv) + 4 * (2 * BH * dk * dv + BH * dv)
    return bound_ms(n_bytes, 7 * BH * dk * dv)


def wkv6_batched_bound(BH: int, T: int, dk: int, dv: int,
                       chunk: int) -> tuple[float, str]:
    """bf16 r, k, w (T dk), v (T dv) and u read, y (float32) written, the
    float32 state read and written."""
    n_bytes = (2 * (3 * BH * T * dk + BH * T * dv + BH * dk)
               + 4 * BH * T * dv + 8 * BH * dk * dv)
    return bound_ms(n_bytes, wkv6_batched_ops(BH, T, dk, dv, chunk))


def compare_wkv6_kernels(dev) -> dict:
    """wkv6_decode and wkv6_batched against their plain versions at
    rwkv6-1.6b's head shape, at each of WKV_DECODE_BH and WKV_BATCHED
    (with w = 0.01, the state written in place and a second launch that
    must repeat the first bit for bit), each printed with its column
    split, and timed there beside its bound."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import rwkv6_scan as kw

    gen = torch.Generator().manual_seed(4)
    rwkv = get_config("rwkv6-1.6b")
    dk = dv = rwkv.rwkv_head_dim
    rows = {}

    def rel_err(got, want):
        return float((got - want).abs().max() / want.abs().max())

    def check(name, shape, tol, got, want):
        (y, s), (py, ps) = got, want
        if not (torch.isfinite(y).all() and torch.isfinite(s).all()):
            fail(f"{name} ({shape}) returned a non-finite value")
        e = max(rel_err(y, py), rel_err(s, ps))
        print(f"compare,{name},{shape},max_rel_err={e},tolerance={tol}")
        if not e <= tol:
            fail(f"{name} ({shape}) differs from its plain version by {e} "
                 f"of its largest magnitude")
        return max(float((y - py).abs().max()), float((s - ps).abs().max()))

    def repeats_in_place(name, fn, ins, shape):
        """Out of place twice, then in place: the same bits each time."""
        y1, s1 = fn(*ins)
        y2, s2 = fn(*ins)
        state = ins[5].clone()
        y3, _ = fn(*ins[:5], state, out_state=state)
        if not (torch.equal(y1, y2) and torch.equal(s1, s2)
                and torch.equal(y1, y3) and torch.equal(s1, state)):
            fail(f"{name} ({shape}): a second launch or the in-place "
                 f"launch differs from the first")

    err, timed = 0.0, []
    for BH in WKV_DECODE_BH:
        n_col = kw.col_split(BH, dv)
        for dtype, w in ((torch.float32, None), (torch.bfloat16, None),
                         (torch.bfloat16, 0.01)):
            ins = wkv_inputs(dev, gen, BH, 0, dk, dtype, w=w)
            shape = (f"BH={BH},{dk}x{dv},{dtype},w={w or 'model'},"
                     f"n_col={n_col}")
            err = max(err, check("wkv6_decode", shape, 1e-5,
                                 kw.wkv6_decode(*ins),
                                 kw.wkv6_decode_plain(*ins)))
        repeats_in_place("wkv6_decode", kw.wkv6_decode, ins, shape)
        ins = wkv_inputs(dev, gen, BH, 0, dk, torch.bfloat16)
        state = ins[5].clone()
        launch = lambda: kw.wkv6_decode(  # noqa: E731
            *ins[:5], state, out_state=state)
        ms = graph_ms(launch, 200)
        b, by = wkv6_decode_bound(BH, dk, dv)
        timed.append(("wkv6_decode", dict(shape=f"BH={BH}", ms=ms,
                                          bound_ms=b, bound_by=by)))
        print(f"wkv6_decode,timed BH={BH},n_col={n_col},ms={ms},"
              f"bound_ms={b} ({by})")
        if BH == WKV_ROW["wkv6_decode"]:
            _report(rows, "wkv6_decode",
                    source="src/repro_torch/csrc/wkv6.cu",
                    replaces="src/repro/kernels/rwkv6_scan.py:124",
                    shape=f"BH={BH} {dk}x{dv}, bf16 inputs, state in place",
                    bound_ms=b, bound_by=by)
            _time(rows, "wkv6_decode", launch,
                  lambda: kw.wkv6_decode_plain(*ins), "wkv6_decode", 200)
    rows["wkv6_decode"]["max_abs_err"] = err

    err = 0.0
    for BH, T in WKV_BATCHED:
        n_col = kw.col_split(BH, dv)
        cases = [("model", None)] + ([("0.01", 0.01)] if T == 64 else [])
        for label, w in cases:
            ins = wkv_inputs(dev, gen, BH, T, dk, torch.bfloat16, w=w)
            shape = (f"BH={BH},T={T},{dk}x{dv},bf16,w={label},"
                     f"chunk={kw.CHUNK},n_col={n_col}")
            err = max(err, check("wkv6_batched", shape, 1e-4,
                                 kw.wkv6_batched(*ins),
                                 kw.wkv6_batched_plain(*ins)))
        repeats_in_place("wkv6_batched", kw.wkv6_batched, ins, shape)
        ins = wkv_inputs(dev, gen, BH, T, dk, torch.bfloat16)
        launch = lambda: kw.wkv6_batched(*ins)  # noqa: E731
        ms = graph_ms(launch, 100 if T < 1000 else 20)
        b, by = wkv6_batched_bound(BH, T, dk, dv, kw.CHUNK)
        timed.append(("wkv6_batched", dict(shape=f"BH={BH} T={T}", ms=ms,
                                           bound_ms=b, bound_by=by)))
        print(f"wkv6_batched,timed BH={BH},T={T},n_col={n_col},ms={ms},"
              f"bound_ms={b} ({by})")
        if (BH, T) == WKV_ROW["wkv6_batched"]:
            _report(rows, "wkv6_batched",
                    source="src/repro_torch/csrc/wkv6.cu",
                    replaces="src/repro/kernels/rwkv6_scan.py:69",
                    shape=f"BH={BH} T={T} {dk}x{dv}, bf16 inputs, chunk "
                          f"{kw.CHUNK}", bound_ms=b, bound_by=by)
            _time(rows, "wkv6_batched", launch,
                  lambda: kw.wkv6_batched_plain(*ins), "wkv6_batched", 100)
    rows["wkv6_batched"]["max_abs_err"] = err
    check_wkv6_padding(dev, gen)
    for name in rows:
        rows[name]["shapes"] = [t for k, t in timed if k == name]
    rows["wkv6_batched"]["backward"] = compare_wkv6_grads(dev)
    return rows


def wkv6_grads(fn, ins, dy, ds):
    """Gradients of sum(y dy) + sum(S ds) through ``fn`` by autograd."""
    import torch
    leaves = [t.detach().clone().requires_grad_() for t in ins]
    y, s = fn(*leaves)
    return torch.autograd.grad((y.float() * dy).sum() + (s * ds).sum(),
                               leaves)


def compare_wkv6_grads(dev) -> dict:
    """WKV6BatchedFn (the kernel's forward, the backward's PyTorch ops)
    against autograd through wkv6_batched_plain on the card at
    WKV_GRAD_CASES, every gradient (the state's included) within
    WKV_GRAD_TOL of its largest magnitude; then one backward at the
    training shape as the training path calls it (no state gradient, no
    final-state gradient) timed beside the kernel's forward: ms per call
    (CUDA events around back-to-back calls, host work included), ms as a
    CUDA graph (the device alone) and the kernels one backward launches
    (a profiler trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import rwkv6_scan as kw
    gen = torch.Generator().manual_seed(6)
    dk = dv = get_config("rwkv6-1.6b").rwkv_head_dim
    for BH, T, name, w in WKV_GRAD_CASES:
        dtype = getattr(torch, name)
        ins = wkv_inputs(dev, gen, BH, T, dk, dtype, w=w)
        dy = torch.randn((BH, T, dv), generator=gen).to(dev)
        ds = torch.randn((BH, dk, dv), generator=gen).to(dev)
        got = wkv6_grads(kw.wkv6_batched_train, ins, dy, ds)
        want = wkv6_grads(kw.wkv6_batched_plain, ins, dy, ds)
        torch.cuda.synchronize()
        tol = WKV_GRAD_TOL[name]
        rel = max(float((g.float() - x.float()).abs().max()
                        / x.float().abs().max()) for g, x in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        print(f"compare,wkv6_batched_grad,BH={BH},T={T},{dk}x{dv},{name},"
              f"w={w or 'model'},max_rel_err={rel},tolerance={tol}")
        if not (finite and rel <= tol):
            fail(f"WKV6BatchedFn gradients (BH={BH}, T={T}, {name}, w={w})"
                 f" differ from autograd through the plain version by {rel}"
                 f" of their largest magnitude (tolerance {tol})")
        del got, want
        torch.cuda.empty_cache()
    BH, T = 32, TRAIN_RWKV_SEQ
    ins = wkv_inputs(dev, gen, BH, T, dk, torch.bfloat16)
    dy = torch.randn((BH, T, dv), generator=gen).to(dev)
    fwd = lambda: kw.wkv6_batched(*ins)  # noqa: E731
    bwd = lambda: kw.wkv6_batched_backward(*ins, dy, None)  # noqa: E731
    b, by = wkv6_batched_bound(BH, T, dk, dv, kw.CHUNK)
    out = dict(shape=f"BH={BH} T={T} {dk}x{dv}, bf16 inputs",
               forward_ms=graph_ms(fwd, 10), forward_bound_ms=b,
               forward_bound_by=by, ms=call_ms(bwd, 5),
               graph_ms=graph_ms(bwd, 3))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bwd()
        torch.cuda.synchronize()
    kernels = device_events(prof)
    out["kernels"] = sum(e.count for e in kernels)
    out["device_ms"] = sum(device_us(e) for e in kernels) / 1e3
    print(f"wkv6_batched_backward,timed {out['shape']}: "
          f"forward_ms={out['forward_ms']},forward_bound_ms={b} ({by}),"
          f"backward_ms={out['ms']},"
          f"backward_graph_ms={out['graph_ms']},"
          f"backward_device_ms={out['device_ms']},"
          f"kernels={out['kernels']}")
    return out


# ------------------------------------------------------------ phase 4
def serve_requests(vocab: int, n: int = SERVE_REQUESTS,
                   prompts=SERVE_PROMPTS):
    """n requests, their lengths cycling over ``prompts``, seeded
    tokens."""
    import numpy as np
    from repro_torch.runtime import Request
    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(
        0, vocab, size=prompts[i % len(prompts)]).astype(np.int32),
        max_new_tokens=SERVE_NEW) for i in range(n)]


def run_serving(model, params, *, failing: bool):
    """Threaded rDLB (SS, P=4) over the requests -> (requests, stats,
    wall seconds); worker 1 fail-stops after 2 requests when
    ``failing``."""
    import torch
    from repro_torch import api
    from repro_torch.runtime import RDLBServeExecutor
    reqs = serve_requests(model.cfg.vocab_size)
    ex = RDLBServeExecutor(model, params, spec=api.serve_spec(
        technique="SS", n_workers=4, threaded=True))
    t0 = time.perf_counter()
    st = ex.serve(reqs, fail_at={1: 2} if failing else None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = sum(r.output is not None for r in reqs)
    if st.hung or done != len(reqs):
        fail(f"{model.cfg.name}: serving finished {done}/{len(reqs)} "
             f"requests (hung={st.hung})")
    for r in reqs:
        if r.output.shape != (SERVE_NEW,) or not (
                (r.output >= 0) & (r.output < model.cfg.vocab_size)).all():
            fail(f"{model.cfg.name}: request {r.rid} output malformed: "
                 f"{r.output}")
    return reqs, st, wall


@contextlib.contextmanager
def plain_versions():
    """Route the models' kernel calls to the plain versions (on the card)
    for a reference run; launch counts must not move meanwhile."""
    from repro_torch.kernels import dispatch, ops
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import rwkv6_scan as kw
    from repro_torch.runtime import serve_executor

    def with_out(plain):
        def fn(*args, out_state=None, **kwargs):
            y, s = plain(*args, **kwargs)
            return y, (s if out_state is None else out_state.copy_(s))
        return fn

    swap = {"flash_decode_gqa": kf.flash_decode_gqa_plain,
            "flash_attention_gqa": kf.flash_attention_gqa_plain,
            "wkv6_decode": with_out(kw.wkv6_decode_plain),
            "wkv6_batched": with_out(kw.wkv6_batched_plain),
            "wkv6_batched_train": kw.wkv6_batched_plain}
    saved = {name: getattr(ops, name) for name in swap}
    before = dispatch.launches()
    # a lane's kept decode-step graph replays what it captured: drop the
    # graphs of the kernels before the run, and those of the plain
    # versions after it
    serve_executor._free_lanes.clear()
    for name, fn in swap.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
        serve_executor._free_lanes.clear()
    if dispatch.launches() != before:
        fail("a kernel launched during the plain-version run")


def check_plain_tokens(dev, arch: str) -> str:
    """A float32 copy of ``arch`` cut to 2 layers, full width: greedy
    tokens through the kernels equal those through the plain versions."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_executor import FusedGenerator
    cfg = get_config(arch).replace(n_layers=2, dtype="float32")
    model = build_model(cfg)
    params = model.init(1, device=dev)
    gen = FusedGenerator(model)
    rng = np.random.default_rng(1)
    groups = [rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
              for b, s in ((3, SERVE_PROMPTS[0]), (1, SERVE_PROMPTS[-1]))]
    got = [gen(params, p, SERVE_NEW) for p in groups]
    with plain_versions():
        want = [gen(params, p, SERVE_NEW) for p in groups]
    n = sum(g.size for g in got)
    same = sum(int((g == w).sum()) for g, w in zip(got, want))
    del model, params
    torch.cuda.empty_cache()
    if same != n:
        fail(f"{arch} float32 2 layers: {n - same} of {n} greedy tokens "
             f"through the kernels differ from the plain versions'")
    return f"{same}/{n}"


def decode_throughput(model, params) -> dict:
    """FusedGenerator at THROUGHPUT (B, S, new): wall seconds of one
    group, of its prefill alone (new = 1) and of PROFILED_NEW tokens,
    after a warm-up; then one torch.profiler trace of a PROFILED_NEW call
    for the kernels per token position and the device's busy time (the
    sum of kernel durations), whose share of the unprofiled call's wall
    time is the device's busy share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.serve_executor import FusedGenerator
    B, S, new = THROUGHPUT
    gen = FusedGenerator(model)
    prompts = np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, size=(B, S)).astype(np.int32)
    gen(params, prompts, 4)
    times = {}
    for n in (1, PROFILED_NEW, new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = gen(params, prompts, n)
        times[n] = time.perf_counter() - t0
    if toks.shape != (B, new):
        fail(f"{model.cfg.name}: throughput run returned {toks.shape}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gen(params, prompts, PROFILED_NEW)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    kernels = device_events(prof, averages)
    busy_us = sum(device_us(e) for e in kernels)
    host = sorted(averages, key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:5]
    return dict(B=B, S=S, new=new, wall_s=times[new],
                prefill_s=times[1], tok_s=B * new / times[new],
                ms_per_step=(times[new] - times[1]) / (new - 1) * 1e3,
                kernels_per_position=sum(e.count for e in kernels)
                / PROFILED_NEW,
                busy_share=busy_us / 1e6 / times[PROFILED_NEW],
                top_host_ops=[(e.key, e.count,
                               round(e.self_cpu_time_total / 1e3, 3))
                              for e in host])


# One prefill of the longest served prompt, alone (B = 1): the shape at
# which wkv6_batched runs its longest chain of chunks.
PREFILL_ARCH = "rwkv6-1.6b"
PREFILL_T = SERVE_PROMPTS[-1]


def time_prefill(model, params, reps: int = 3) -> list:
    """Wall seconds of ``reps`` calls of ``model.prefill`` on one
    PREFILL_T-token prompt, each on a fresh cache and ending in
    ``torch.cuda.synchronize()``, after one warm-up call."""
    import numpy as np
    import torch
    dev = params["embed"].device
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, size=(1, PREFILL_T))).to(dev)
    walls = []
    for _ in range(reps + 1):
        cache = model.init_cache(1, PREFILL_T, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.prefill(params, cache, tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if logits.shape[:2] != (1, 1) or not torch.isfinite(logits).all():
        fail(f"{model.cfg.name}: prefill returned {tuple(logits.shape)} "
             f"or non-finite logits")
    return [round(w, 6) for w in walls[1:]]


def time_segmented_prefill(model, params, reps: int = 3) -> dict | None:
    """Where the model's groups prefill in segments replayed from CUDA
    graphs (``FusedGenerator.segmented``), the serving path's prefill of
    the PREFILL_T-token prompt: wall seconds of ``reps`` + 1 calls of
    ``FusedGenerator`` for one new token (the segments and one argmax,
    ending when the token reaches the host), those in which a segment
    captured its graph apart from those that only replayed kept graphs,
    with the segments of each kind; None where it does not.  The card's
    kept lanes are dropped first, so the first call captures."""
    import numpy as np
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models.common import first_tensor
    from repro_torch.runtime import serve_executor as se
    dev = first_tensor(params).device
    gen = se.FusedGenerator(model)
    if not gen.segmented(dev):
        return None
    prompt = np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, size=(1, PREFILL_T)).astype(np.int32)
    with se._lanes_lock:
        se._free_lanes.pop(dev, None)
    out = {"capture_s": [], "replay_s": [], "captures": 0, "hits": 0}
    for _ in range(reps + 1):
        c0 = dispatch.events(se.PREFILL_CAPTURES)
        h0 = dispatch.events(se.PREFILL_HITS)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tok = gen(params, prompt, 1)
        wall = round(time.perf_counter() - t0, 6)
        captures = dispatch.events(se.PREFILL_CAPTURES) - c0
        out["captures"] += captures
        out["hits"] += dispatch.events(se.PREFILL_HITS) - h0
        out["capture_s" if captures else "replay_s"].append(wall)
    if tok.shape != (1, 1) or not 0 <= tok[0, 0] < model.cfg.vocab_size:
        fail(f"{model.cfg.name}: the segmented prefill returned {tok}")
    return out


def print_prefill_times(model, params) -> None:
    """The ``prefill,`` line of time_prefill and, where the model's
    groups prefill in segments, the ``prefill_segmented,`` line of
    time_segmented_prefill (the path serving runs there)."""
    from repro_torch.runtime.serve_executor import prefill_segments
    cfg = model.cfg
    walls = time_prefill(model, params)
    print(f"prefill,{cfg.name},B=1,T={PREFILL_T},{cfg.dtype}: wall_s of "
          f"{len(walls)} model.prefill calls after a warm-up={walls}")
    seg = time_segmented_prefill(model, params)
    if seg is not None:
        print(f"prefill_segmented,{cfg.name},B=1,T={PREFILL_T},{cfg.dtype}:"
              f" segments {prefill_segments(PREFILL_T)},wall_s of "
              f"FusedGenerator calls of one token that captured="
              f"{seg['capture_s']},that "
              f"replayed kept graphs alone={seg['replay_s']},segments "
              f"captured={seg['captures']},replayed={seg['hits']}")


SERVE_SITES = {"olmo-1b": ("flash_decode", "flash_attention"),
               "rwkv6-1.6b": ("wkv6_decode", "wkv6_batched")}


def serve_drive(dev, cfg, sites) -> tuple:
    """``cfg`` at its width in its dtype with seeded weights through the
    serving drive: a fail-stop run (launch counts set to 0 just before,
    read just after; each of ``sites`` must have launched on the card,
    and at least one duplicate issued), then a failure-free run whose
    tokens the fail-stop run's must equal bit for bit.  Returns (model,
    params, launches of the fail-stop run)."""
    import numpy as np
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import build_model
    arch = cfg.name
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"serve,{arch},layers={cfg.n_layers},params={n_params},"
          f"{cfg.dtype},init_s={time.perf_counter() - t0:.3f}")
    dispatch.reset_launches()
    reqs, st, wall = run_serving(model, params, failing=True)
    launches = dispatch.launches()
    print(f"rdlb,serve,{arch},requests={len(reqs)},"
          f"n_duplicates={st.n_duplicates},wasted={st.wasted_requests},"
          f"by_worker={st.by_worker},wall_s={wall:.4f},"
          f"tokens={len(reqs) * SERVE_NEW}")
    print(f"launches on the {arch} serving path: {launches}")
    check_sites(arch, launches, sites)
    if st.n_duplicates < 1:
        fail(f"{arch}: the fail-stop run issued no rDLB duplicate")
    calm, _, calm_wall = run_serving(model, params, failing=False)
    bad = [r.rid for r, c in zip(reqs, calm)
           if not np.array_equal(r.output, c.output)]
    if bad:
        fail(f"{arch}: requests {bad} under a fail-stop differ from the "
             f"failure-free run")
    print(f"rdlb,serve,{arch}: fail-stop tokens equal the failure-free "
          f"run's bit for bit (failure-free wall_s={calm_wall:.4f})")
    return model, params, launches


def check_sites(arch: str, launches: dict, sites) -> None:
    """Each of ``sites`` launched on ``arch``'s path, on the card."""
    from repro_torch.kernels import dispatch
    status = dispatch.status()
    for site in sites:
        if launches.get(site, 0) <= 0:
            fail(f"kernel {site} was not launched on the {arch} serving "
                 f"path")
        if status.get(site, {}).get("path") != "cuda":
            fail(f"dispatch status of {site} is {status.get(site)}")


def drive_serving(dev, arch: str) -> dict:
    """Phase 4 for one arch; returns the kernel launches of its fail-stop
    run and prints its numbers."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(arch).replace(n_layers=EARLIER_DEPTH[arch])
    model, params, launches = serve_drive(dev, cfg, SERVE_SITES[arch])
    tp = decode_throughput(model, params)
    print(f"decode,{arch},B={tp['B']},S={tp['S']},new={tp['new']},"
          f"wall_s={tp['wall_s']:.4f},prefill_s={tp['prefill_s']:.4f},"
          f"tok_s={tp['tok_s']:.1f},ms_per_step={tp['ms_per_step']:.3f}")
    print(f"decode,{arch},profiled new={PROFILED_NEW}: kernels per token "
          f"position={tp['kernels_per_position']:.1f},device busy share="
          f"{tp['busy_share']:.3f},top host ops (name, calls, self ms)="
          f"{tp['top_host_ops']}")
    if arch == PREFILL_ARCH:
        print_prefill_times(model, params)
    del model, params
    torch.cuda.empty_cache()
    same = check_plain_tokens(dev, arch)
    print(f"check,{arch},float32 2 layers: kernel tokens equal plain "
          f"tokens {same}")
    return {site: launches[site] for site in SERVE_SITES[arch]}

# ------------------------------------------------------------ phase 5
# olmo-1b training: global batch TRAIN_BATCH x TRAIN_SEQ tokens (its
# published context), TRAIN_TASKS microbatches over TRAIN_WORKERS threads,
# TRAIN_STEPS steps; worker 1 fail-stops during step 1 of the second run.
TRAIN_ARCH = "olmo-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_TASKS = 8, 2048, 8
TRAIN_WORKERS, TRAIN_STEPS, TRAIN_FAIL_STEP = 4, 3, 1
# rwkv6-1.6b trains the same way at rows of TRAIN_RWKV_SEQ tokens: the
# reference's own training cell for it (train_4k).  Each run: (row
# length, the kernel that carries it).
TRAIN_RWKV_SEQ = 4096
TRAIN_RUNS = {"olmo-1b": (TRAIN_SEQ, "flash_attention"),
              "rwkv6-1.6b": (TRAIN_RWKV_SEQ, "wkv6_batched")}
# The train CLI's checkpoint/restart on the card, at its smoke configs.
TRAIN_CKPT_ARGS = ["--smoke", "--steps", "4", "--global-batch", "4",
                   "--seq-len", "64", "--n-workers", "2", "--n-tasks", "2",
                   "--no-rdlb"]
RESTART_FAIL_STEP = 2
# WKV6BatchedFn's gradients (phase 2): rwkv6-1.6b's training shape (one
# row, BH = 32), a ragged T in both dtypes and strong decay; against
# autograd through the plain version, within 1e-4 of each gradient's
# largest magnitude in float32 (the two sum in other orders through 32
# to 128 chunks) and 2**-6 in bfloat16 (each rounds its float32 gradient
# to 8 significant bits)
WKV_GRAD_CASES = (  # (BH, T, dtype, w)
    (32, TRAIN_RWKV_SEQ, "bfloat16", None), (32, 1000, "float32", None),
    (32, 1000, "bfloat16", None), (32, 1000, "float32", 0.01),
    (32, TRAIN_RWKV_SEQ, "bfloat16", 0.01))
WKV_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
# rwkv6's float32 check copy runs twice: at the seeded weights, as the
# training runs have them, and with the time-first bonus u and the decay
# offset w0 of every layer drawn from N(0, 0.5) (CHECK_DRAW_SEED), as a
# trained model has them.  At the seeded weights u = 0 and the state
# starts at 0, so every head's first output is exactly 0 and the group
# norm's backward multiplies by 1 / sqrt(eps) there: the plain path alone
# then moves u's gradient by about 1.5e-3 of its size between the card
# and the CPU (printed beside each case), so the seeded case holds within
# SEEDED_RWKV_GRAD_TOL, and the drawn case within GRAD_TOL["model"].
CHECK_DRAW_SEED = 3
SEEDED_RWKV_GRAD_TOL = 1e-3
# The float32 check copy: 2 layers, full width, one row of a ragged S.
CHECK_SEQ = 1000
# Gradient tolerances, relative to each gradient's largest magnitude:
# float32 both ways (kernel + FlashAttentionFn's backward vs. the plain
# ops under autograd, which sum in other orders) 1e-5 for one attention
# call and 1e-4 through two layers of the model; bfloat16 gradients
# within 2**-6 of it (each holds 8 significant bits and the two sides
# round differently).
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6, "model": 1e-4}


def attention_ops(B: int, H: int, S: int, D: int, Dv: int,
                  causal: bool) -> float:
    """Matrix-product FLOPs of attention over the (query, key) pairs it
    computes: 2 D for the score, 2 Dv for P V."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return B * H * pairs * (2 * D + 2 * Dv)


def compare_attention_kernel(dev) -> dict:
    """flash_attention against its plain version on ``dev`` (output, lse
    and gradients), at olmo-1b's training shape and at ragged, GQA,
    non-causal, Dv != D and D = 256 shapes (gradients at the bfloat16
    ones of the wgmma variant); then timed at the training shape."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import flash_attention as kf

    gen = torch.Generator().manual_seed(3)
    olmo = get_config(TRAIN_ARCH)
    H, D = olmo.n_heads, olmo.head_dim
    cases = [  # (label, B, S, H, KV, D, Dv, causal, dtype, variant)
        ("olmo-1b training", 1, TRAIN_SEQ, H, olmo.n_kv_heads, D, D, True,
         torch.bfloat16, "wgmma"),
        ("ragged gqa", 2, 1000, 8, 2, 128, 128, True, torch.float32,
         "fp32"),
        ("ragged gqa", 2, 1000, 8, 2, 128, 128, True, torch.bfloat16,
         "wgmma"),
        ("non-causal", 2, 300, 4, 4, 64, 64, False, torch.float32, "fp32"),
        ("dv != d", 1, 257, 4, 1, 192, 128, True, torch.float32, "fp32"),
        ("dv != d", 1, 257, 4, 1, 192, 128, True, torch.bfloat16, "wgmma"),
        ("dims 256", 1, 130, 2, 2, 256, 256, True, torch.bfloat16,
         "wgmma"),
        ("dims 64", 2, 333, 8, 4, 64, 64, True, torch.bfloat16, "wgmma"),
        ("non-causal", 1, 200, 4, 4, 128, 128, False, torch.bfloat16,
         "wgmma"),
    ]
    err = 0.0
    for label, B, S, Hh, KV, Dq, Dv, causal, dtype, want in cases:
        q = torch.randn((B, S, Hh, Dq), generator=gen).to(dev, dtype)
        k = torch.randn((B, S, KV, Dq), generator=gen).to(dev, dtype)
        v = torch.randn((B, S, KV, Dv), generator=gen).to(dev, dtype)
        out, lse = kf.flash_attention_forward(q, k, v, causal=causal)
        variant = dispatch.status("flash_attention").get("variant")
        pout, plse = kf.flash_attention_forward_plain(q, k, v,
                                                      causal=causal)
        torch.cuda.synchronize()
        if variant != want:
            fail(f"flash_attention ({label}, {dtype}) ran the {variant} "
                 f"variant, not {want}")
        d_out = (out.float() - pout.float()).abs()
        d_lse = (lse - plse).abs()
        # float32 within 1e-5; bfloat16 within one rounding of the output
        # plus what rounding P to bfloat16 before P V can move it
        atol, rtol = (1e-5, 0.0) if dtype == torch.float32 else (
            1e-4, 2.0 ** -7)
        tol = atol + rtol * pout.float().abs()
        if dtype == torch.bfloat16:
            tol = tol + kf.bf16_p_bound(q, k, v, causal=causal)
        ok_out = bool((d_out <= tol).all())
        ok_lse = bool((d_lse <= 1e-5 + 1e-6 * plse.abs()).all())
        e = float(d_out.max())
        print(f"compare,flash_attention,{label},B={B},S={S},H={Hh},"
              f"KV={KV},D={Dq},Dv={Dv},causal={causal},{dtype},"
              f"variant={variant},max_abs_err={e},tolerance={atol}+{rtol}"
              f"*|plain|{'+bf16_p_bound' if dtype != torch.float32 else ''}"
              f",lse_max_abs_err={float(d_lse.max())},"
              f"lse_tolerance=1e-05+1e-06*|plain|")
        if not (ok_out and ok_lse):
            fail(f"flash_attention ({label}, {dtype}) differs from its "
                 f"plain version: output {e}, lse {float(d_lse.max())}")
        err = max(err, e)
        if label in ("olmo-1b training", "ragged gqa") or (
                label in ("dv != d", "dims 256")
                and dtype == torch.bfloat16):
            check_attention_grads(kf, q, k, v, causal, label, dtype, gen)
    # timed: olmo-1b's training shape, one microbatch row
    B, S, KV = 1, TRAIN_SEQ, olmo.n_kv_heads
    q = torch.randn((B, S, H, D), generator=gen).to(dev, torch.bfloat16)
    k = torch.randn((B, S, KV, D), generator=gen).to(dev, torch.bfloat16)
    v = torch.randn((B, S, KV, D), generator=gen).to(dev, torch.bfloat16)
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) \
        + 4 * B * H * S
    ops = attention_ops(B, H, S, D, D, True)
    b, by = bound_ms(n_bytes, ops, peak=PEAK_BF16)
    # bound_ms is held to the bf16 tensor-core peak; the same work at the
    # FP32 peak (where this kernel's products run) is printed beside it
    # and is not a bound of the kernel.
    b32, _ = bound_ms(n_bytes, ops, peak=PEAK_FP32)
    print(f"bound,flash_attention,gflop={ops / 1e9},bytes={n_bytes},"
          f"bound_ms={b} (bf16 tensor cores 989 TFLOP/s),"
          f"same work at the FP32 peak 67 TFLOP/s={b32} ms")
    rows = {}
    _report(rows, "flash_attention",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:145",
            shape=f"q,k,v ({B},{S},{H},{D}) bf16, causal, with lse",
            max_abs_err=err, bound_ms=b, bound_by=by)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(qh, kh, vh, is_causal=True)  # noqa: E731
    _time(rows, "flash_attention",
          lambda: kf.flash_attention_forward(q, k, v, causal=True),
          lambda: kf.flash_attention_forward_plain(q, k, v, causal=True),
          "flash_attention_wgmma_kernel", 20, library=library)
    # the variant the timed launches ran, as the wrapper recorded it
    variant = dispatch.status("flash_attention").get("variant")
    if variant != "wgmma":
        fail(f"the timed flash_attention launches ran the {variant} variant")
    rows["flash_attention"]["variant"] = variant
    rows["flash_attention"]["library"] = sdpa_backend(library)
    return rows


def check_attention_grads(kf, q, k, v, causal, label, dtype, gen) -> None:
    """Gradients of sum(out * dout) through FlashAttentionFn (kernel
    forward) against autograd through the plain version's ops."""
    import torch
    dout = torch.randn(q.shape[:3] + v.shape[-1:], generator=gen).to(
        q.device, dtype)
    grads = []
    for fn in (kf.flash_attention_gqa, kf.flash_attention_gqa_plain):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, causal=causal)
        grads.append(torch.autograd.grad(out, leaves, dout))
    torch.cuda.synchronize()
    tol = GRAD_TOL["float32" if dtype == torch.float32 else "bfloat16"]
    worst = 0.0
    for name, g, w in zip("qkv", *grads):
        rel = float((g.float() - w.float()).abs().max()
                    / w.float().abs().max())
        worst = max(worst, rel)
        if not rel <= tol:
            fail(f"flash_attention d{name} ({label}, {dtype}) differs from "
                 f"autograd through the plain version by {rel} of its "
                 f"largest magnitude (tolerance {tol})")
    print(f"compare,flash_attention_grad,{label},{dtype},"
          f"max_rel_err={worst},tolerance={tol}")


def sdpa_backend(library) -> str:
    """Names of the CUDA kernels one SDPA call launched (the backend that
    ran), from a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        library()
        torch.cuda.synchronize()
    names = sorted({e.key for e in device_events(prof)})
    return "; ".join(n[:100] for n in names) or "unknown"


def profile_train_task(model, params, seq: int) -> None:
    """One training task (forward and backward of one ``seq``-token row,
    as a worker runs it) timed alone and then traced: its wall time, the
    device's busy time and share, kernels launched, and the kernels that
    take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import as_tensors, batch_for_step
    from repro_torch.runtime.executor import value_and_grad
    arch = model.cfg.name
    batch = as_tensors(batch_for_step(model.cfg, 0, 1, seq),
                       params["embed"].device)
    fn = lambda p, b: model.loss(p, b)[0]  # noqa: E731
    value_and_grad(fn, params, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value_and_grad(fn, params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        value_and_grad(fn, params, batch)
        torch.cuda.synchronize()
    kernels = device_events(prof)
    busy = sum(device_us(e) for e in kernels) / 1e6
    top = [(e.key[:60], e.count, round(device_us(e) / 1e3, 3),
            round(device_us(e) / 1e6 / busy, 3))
           for e in sorted(kernels, key=device_us, reverse=True)[:8]]
    print(f"train,{arch},profiled task (1 x {seq} tokens, forward, "
          f"recomputed forward and backward): wall_s={wall:.4f},"
          f"device_busy_s={busy:.4f},busy_share={busy / wall:.3f},kernels="
          f"{sum(e.count for e in kernels)},top device kernels (name, "
          f"calls, ms, share of busy)={top}")


def wgmma_launches() -> int:
    """Launches of flash_attention's wgmma variant so far."""
    from repro_torch.kernels import dispatch
    return dispatch.variant_launches("flash_attention").get("wgmma", 0)


def params_on_host(params) -> list:
    from repro_torch.models.common import tree_leaves
    return [t.detach().to("cpu") for t in tree_leaves(params)]


def run_training(model, params, *, seq: int, site: str, failing: bool,
                 reference=None):
    """TRAIN_STEPS threaded rDLB steps of TRAIN_BATCH rows of ``seq``
    tokens from ``params``.  With ``failing``, worker 1 fail-stops during
    step TRAIN_FAIL_STEP, at its first assignment there, holding that
    chunk.  Returns (per-step host copies of the parameters, per-step
    records with the launches of kernel ``site``); with ``reference`` (a
    failure-free run's copies) each step's parameters must equal it bit
    for bit."""
    import math
    import torch
    from repro_torch import api
    from repro_torch.data import batch_for_step
    from repro_torch.kernels import dispatch
    from repro_torch.runtime import RDLBTrainExecutor
    from repro_torch.runtime.elastic import shrink_to_survivors
    spec = api.train_spec(technique="FAC", n_workers=TRAIN_WORKERS,
                          n_tasks=TRAIN_TASKS, threaded=True)
    ex = RDLBTrainExecutor(model, spec=spec, optimizer="adamw", lr=1e-4,
                           exact_accumulation=True)
    opt_state = ex.opt.init(params)
    snaps, records = [], []
    for step in range(TRAIN_STEPS):
        batch = batch_for_step(model.cfg, step, TRAIN_BATCH, seq)
        if failing and step == TRAIN_FAIL_STEP:
            w = ex.workers[1]
            w.fail_after_tasks = w.tasks_done
        before = dispatch.launches(site)
        before_wgmma = wgmma_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ex.train_step(params, opt_state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if res.hung or not math.isfinite(res.loss):
            fail(f"training step {step} (failing={failing}): hung="
                 f"{res.hung}, loss={res.loss}")
        params, opt_state = res.params, res.opt_state
        rec = dict(step=step, loss=res.loss, seconds=dt,
                   tokens_s=TRAIN_BATCH * seq / dt,
                   n_duplicates=res.n_duplicates, wasted=res.wasted_tasks,
                   by_worker=res.tasks_by_worker, survivors=res.survivors)
        rec[f"{site}_launches"] = dispatch.launches(site) - before
        if site == "flash_attention":
            rec["wgmma_launches"] = wgmma_launches() - before_wgmma
        records.append(rec)
        snap = params_on_host(params)
        if reference is not None:
            bad = sum(not torch.equal(a, b)
                      for a, b in zip(snap, reference[step]))
            if bad:
                fail(f"training step {step}: {bad} parameter tensors under "
                     f"the fail-stop differ from the failure-free run's")
            rec["bit_identical"] = True
        snaps.append(snap)
        shrink_to_survivors(ex)
    return snaps, records


def drive_training(dev, arch: str) -> int:
    """Phase 5's training runs of ``arch`` (TRAIN_RUNS); returns its
    kernel's launches in the fail-stop run (counts set to 0 just before
    it, read just after)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models import build_model
    seq, site = TRAIN_RUNS[arch]
    cfg = get_config(arch).replace(n_layers=EARLIER_DEPTH[arch])
    model = build_model(cfg)
    params = model.init(0, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"train,{arch},layers={cfg.n_layers},params={n_params},"
          f"{cfg.dtype},"
          f"global_batch={TRAIN_BATCH}x{seq},tasks={TRAIN_TASKS},"
          f"workers={TRAIN_WORKERS},technique=FAC,optimizer=adamw,"
          f"steps={TRAIN_STEPS},remat=each layer")
    torch.cuda.reset_peak_memory_stats()
    calm, calm_rec = run_training(model, params, seq=seq, site=site,
                                  failing=False)
    for r in calm_rec:
        print(f"train,{arch},failure-free,{json.dumps(r)}")
    dispatch.reset_launches()
    _, rec = run_training(model, params, seq=seq, site=site, failing=True,
                          reference=calm)
    launches = dispatch.launches()
    status = dispatch.status(site)
    for r in rec:
        print(f"train,{arch},fail-stop,{json.dumps(r)}")
    variants = dispatch.variant_launches("flash_attention")
    print(f"launches on the {arch} training path: {launches}; "
          f"flash_attention by variant: {variants}")
    if launches.get(site, 0) <= 0 or status.get("path") != "cuda":
        fail(f"{site} was not launched on the {arch} training path "
             f"({launches}, {status})")
    for r in rec:
        if site == "flash_attention" and not (
                0 < r["wgmma_launches"] == r["flash_attention_launches"]):
            fail(f"training step {r['step']}: {r['wgmma_launches']} wgmma "
                 f"launches of {r['flash_attention_launches']} "
                 f"flash_attention launches")
    if (rec[TRAIN_FAIL_STEP]["n_duplicates"] < 1
            or 1 in rec[TRAIN_FAIL_STEP]["survivors"]):
        fail(f"the {arch} fail-stop training run lost no worker or issued "
             f"no rDLB duplicate")
    print(f"train,{arch}: parameters after every step under the fail-stop "
          f"equal the failure-free run's bit for bit; "
          f"max_memory_allocated_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    profile_train_task(model, params, seq)
    del model, params, calm
    torch.cuda.empty_cache()
    return launches[site]


def grad_gap(got, want) -> tuple:
    """(largest difference, leaf) of two gradient trees, each leaf's
    relative to its largest magnitude in ``want``; a leaf that is 0 in
    ``want`` must be 0 in ``got`` (else the gap is vast)."""
    import torch
    from repro_torch.models.common import tree_leaves, tree_named_leaves
    tiny = torch.finfo(torch.float32).tiny
    return max(
        (float((g.to(w.device) - w).abs().max()
               / w.abs().max().clamp(min=tiny)), name)
        for (name, g), w in zip(tree_named_leaves(got).items(),
                                tree_leaves(want)))


def draw_check_weights(params) -> None:
    """u and w0 of every rwkv6 layer from N(0, 0.5), seeded (see
    CHECK_DRAW_SEED), in place."""
    import torch
    gen = torch.Generator(device=params["embed"].device)
    gen.manual_seed(CHECK_DRAW_SEED)
    for lp in params["layers"]:
        for key in ("u", "w0"):
            lp["att"][key].data.normal_(0.0, 0.5, generator=gen)


def check_train_float32(dev, arch: str) -> None:
    """A float32 copy of ``arch`` cut to 2 layers (full width): loss and
    gradients of one CHECK_SEQ-token row through the kernels against the
    plain path, both on the card; for rwkv6 at the seeded and at drawn
    weights (see CHECK_DRAW_SEED), each beside the plain path on the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import as_tensors, batch_for_step
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.runtime.executor import value_and_grad
    cfg = get_config(arch).replace(n_layers=2, dtype="float32")
    model = build_model(cfg)
    rows = batch_for_step(cfg, 0, 1, CHECK_SEQ)
    batch = as_tensors(rows, dev)
    loss_fn = lambda p, b: model.loss(p, b)[0]  # noqa: E731
    rwkv = arch == "rwkv6-1.6b"
    cases = ((("seeded weights", SEEDED_RWKV_GRAD_TOL),
              ("u and w0 drawn", GRAD_TOL["model"])) if rwkv
             else (("seeded weights", GRAD_TOL["model"]),))
    for label, tol in cases:
        params = model.init(1, device=dev)
        if label != "seeded weights":
            draw_check_weights(params)
        loss, grads = value_and_grad(loss_fn, params, batch)
        with plain_versions():
            ploss, pgrads = value_and_grad(loss_fn, params, batch)
        torch.cuda.synchronize()
        dl = abs(float(loss) - float(ploss)) / abs(float(ploss))
        worst, leaf = grad_gap(grads, pgrads)
        witness = ""
        if rwkv:
            closs, cgrads = value_and_grad(
                loss_fn, tree_map(torch.Tensor.cpu, params),
                as_tensors(rows, "cpu"))
            cw, cleaf = grad_gap(pgrads, cgrads)
            witness = (f"; plain path card vs CPU: loss rel "
                       f"{abs(float(ploss) - float(closs)) / abs(float(closs))}"
                       f", gradients max_rel_err={cw} (at {cleaf})")
            del cgrads
        print(f"check,{arch},float32 2 layers,S={CHECK_SEQ},{label}: loss "
              f"{float(loss)} vs plain {float(ploss)} (rel {dl}), gradients "
              f"max_rel_err={worst} (at {leaf}),tolerance={tol}{witness}")
        if not (dl <= 1e-5 and worst <= tol):
            fail(f"{arch} float32 2-layer loss or gradients through the "
                 f"kernels differ from the plain path's ({label})")
        del params, grads, pgrads
        torch.cuda.empty_cache()
    del model


def restart_on_the_card() -> None:
    """The train CLI's checkpoint/restart on the card (TRAIN_CKPT_ARGS):
    worker 1 fail-stops in step RESTART_FAIL_STEP of a run without rDLB,
    the step hangs, the CLI restores the checkpoint written after the
    step before and finishes; its losses equal a failure-free run's at
    every step.  Two workers and two tasks: two gradients sum to the
    same bits in either arrival order."""
    import io
    import math
    import tempfile
    from repro_torch.launch import train as ttrain
    for arch in SERVE_ARCHS:
        args = ["--arch", arch, *TRAIN_CKPT_ARGS]
        with tempfile.TemporaryDirectory() as tmp:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                losses = ttrain.main(args + [
                    "--fail", f"{RESTART_FAIL_STEP}:1", "--ckpt-dir", tmp,
                    "--ckpt-interval", "1"])
                calm = ttrain.main(args)
        text = out.getvalue()
        hung = f"step {RESTART_FAIL_STEP}: HUNG" in text
        restored = (f"restored checkpoint at step {RESTART_FAIL_STEP}"
                    in text)
        print(f"restart,{arch},hung={hung},restored={restored},"
              f"losses={losses},failure-free={calm}")
        if not (hung and restored and len(losses) == len(calm)
                and all(math.isfinite(x) for x in losses)
                and losses == calm):
            fail(f"{arch}: the train CLI did not restore and finish with "
                 f"the failure-free run's losses")


# ------------------------------------------------------------ phase 6
# The other model families at full width in bfloat16 with seeded weights.
# deepseek-v2-lite-16b (MLA + 64 routed experts, top-6) and hymba-1.5b go
# through phase 4's serving drive (16 requests, prompts 37/64/1000, 16 new
# tokens, worker 1 fail-stopping after 2); paligemma-3b and whisper-tiny
# serve FEW_REQUESTS requests of FEW_PROMPTS through the same executor.
# deepseek is served as the benchmark serves it (published_deepseek: the
# dropless routing, YaRN).  The kernels each run must launch (deepseek's
# serving path: flash_attention in MLA's prefill, which the card computes
# in the decompressed form, and the dropless MoE kernels, moe_route and
# moe_gemm, in every MoE layer of a prefill and a decode step; MLA decodes
# in the absorbed form, as the reference does).  The registry's config
# (the reference's GShard experts) is held to the CPU in float32.
FAMILY_ARCHS = ("deepseek-v2-lite-16b", "hymba-1.5b")
# deepseek runs at full depth (27 layers, 31.4 GB: the point is that one
# card holds it whole); hymba at 16 of its 32 layers (its global layers 0
# and 15 beside 14 windowed ones), to keep the script near 600 s: its
# serving drive launches about 3,700 kernels a token from 4 threads.
FAMILY_DEPTH = {"hymba-1.5b": 16}
FEW_ARCHS = ("paligemma-3b", "whisper-tiny")
FEW_REQUESTS = 4
# whisper has no prefill: it walks a prompt through decode_step a token a
# step, which at 1000 tokens (twice, with a duplicate) took 44-64 s of
# the script on an H100 80GB HBM3 at 700 W, so it serves the two short
# prompts.
FEW_PROMPTS = {"paligemma-3b": SERVE_PROMPTS,
               "whisper-tiny": SERVE_PROMPTS[:2]}
FAMILY_SITES = {"deepseek-v2-lite-16b": ("flash_attention", "moe_route",
                                         "moe_gemm"),
                "hymba-1.5b": ("flash_decode", "flash_attention"),
                "paligemma-3b": ("flash_decode", "flash_attention"),
                "whisper-tiny": ("flash_decode",)}
# ms per decode step at B = 1: FusedGenerator on one DECODE_PROMPT-token
# prompt, (DECODE_NEW + 1 tokens - 1 token) / DECODE_NEW steps.
DECODE_PROMPT, DECODE_NEW = 64, 16
# deepseek's float32 2-layer copy (layer 0 dense, layer 1 MoE) on the card
# against the CPU: the same greedy tokens, and the last logits of the
# forward (its MLA through flash_attention's fp32 variant at D = 192 on
# the card, as every float32 input goes; the bfloat16 model's MLA forward
# takes the wgmma variant) and of the prefill within CPU_LOGIT_TOL =
# (atol, rtol): the card's and the CPU's float32 products sum 2,048- to
# 10,944-long dot products in other orders.
CPU_LOGIT_TOL = (1e-3, 1e-4)
# The ten smoke configs in float32, card against CPU (SMOKE_TOL): logits
# 1e-4 + 1e-5 of their size, the loss 1e-5 of it, gradients 1e-4 of each
# leaf's largest magnitude (as tests/test_torch_cuda.py).
SMOKE_TOL = {"logits": (1e-4, 1e-5), "loss": 1e-5, "grads": 1e-4}


def weight_bytes(params) -> int:
    """Bytes of the parameters a decode step reads: every leaf once,
    except the token embedding (one row)."""
    from repro_torch.models.common import tree_named_leaves
    return sum((t.shape[-1] if path == "embed" else t.numel())
               * t.element_size()
               for path, t in tree_named_leaves(params).items())


def decode_step_ms(model, params) -> dict:
    """Milliseconds per decode step at B = 1 (see DECODE_NEW), the better
    of two timings; then one torch.profiler trace of a call generating
    PROFILED_NEW tokens: kernels per token position, the device's busy
    share of the call and its top device kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.serve_executor import FusedGenerator
    gen = FusedGenerator(model)
    prompt = np.random.default_rng(4).integers(
        0, model.cfg.vocab_size, size=(1, DECODE_PROMPT)).astype(np.int32)
    gen(params, prompt, 2)
    walls = {}
    for n in (1, DECODE_NEW + 1, 1, DECODE_NEW + 1, PROFILED_NEW):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen(params, prompt, n)
        walls[n] = min(walls.get(n, 1e9), time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gen(params, prompt, PROFILED_NEW)
        torch.cuda.synchronize()
    kernels = device_events(prof)
    busy_us = sum(device_us(e) for e in kernels)
    top = sorted(kernels, key=device_us, reverse=True)[:5]
    return dict(ms=(walls[DECODE_NEW + 1] - walls[1]) / DECODE_NEW * 1e3,
                kernels_per_position=sum(e.count for e in kernels)
                / PROFILED_NEW,
                busy_share=busy_us / 1e6 / walls[PROFILED_NEW],
                top=[(e.key[:48], e.count, round(device_us(e) / 1e3, 3))
                     for e in top])


def drive_family(dev, arch: str) -> dict:
    """Phase 6 for one of FAMILY_ARCHS: the serving drive through a
    fail-stop, peak memory, a decode step at B = 1 beside its bound, and
    one 1000-token prefill.  Returns the launches of the fail-stop run."""
    import gc
    import torch
    from repro_torch.configs import get_config
    cfg = (published_deepseek() if arch == "deepseek-v2-lite-16b"
           else get_config(arch))
    cfg = cfg.replace(n_layers=FAMILY_DEPTH.get(arch, cfg.n_layers))
    torch.cuda.reset_peak_memory_stats()
    model, params, launches = serve_drive(dev, cfg, FAMILY_SITES[arch])
    if cfg.moe_dropless:
        check_moe_launches(cfg, launches)
    step = decode_step_ms(model, params)
    ms = step["ms"]
    n_bytes = weight_bytes(params)
    b, _ = bound_ms(n_bytes, 0.0)
    extra = ""
    if cfg.moe:
        n_moe = cfg.n_layers - cfg.n_dense_layers
        n_read = cfg.top_k if cfg.moe_dropless else cfg.n_routed_experts
        e_bytes = n_moe * n_read * 3 * cfg.d_model * cfg.d_expert * 2
        extra = (f",routed experts read a step ({n_read} a layer)="
                 f"{e_bytes / 1e9:.2f} GB -> "
                 f"{bound_ms(e_bytes, 0.0)[0]:.3f} ms")
    print(f"decode,{arch},B=1,S={DECODE_PROMPT},ms_per_step={ms:.3f},"
          f"bound: weights read a step={n_bytes / 1e9:.2f} GB at "
          f"{PEAK_BYTES / 1e12} TB/s -> {b:.3f} ms{extra}")
    print(f"decode,{arch},profiled B=1 new={PROFILED_NEW}: kernels per "
          f"token position={step['kernels_per_position']:.1f},device busy "
          f"share={step['busy_share']:.3f},top device kernels (name, calls, "
          f"ms)={step['top']}")
    print_prefill_times(model, params)
    print(f"memory,{arch},peak_allocated_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_moe_launches(cfg, launches: dict) -> None:
    """The fail-stop serving run of the dropless config (launch counts
    set to 0 just before it): moe_route once and moe_gemm twice a MoE
    layer a model call; the drive's two runs (fail-stop, failure-free)
    launched both variants (the prefills' tile, the decode steps'
    small_m).  Prints the counts and the routed rows' largest (layer,
    expert) load over the mean, over the drive's two runs."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import moe as km
    n_moe = cfg.n_layers - cfg.n_dense_layers
    route = launches.get("moe_route", 0)
    by_var = dispatch.variant_launches("moe_gemm")
    rows = dispatch.device_counters()[km.ROWS_COUNTER]
    rows = rows[cfg.n_dense_layers:].double().cpu()
    load = float(rows.max() / rows.mean()) if rows.sum() else None
    print(f"moe,{cfg.name},serving: moe_route launches={route},moe_gemm "
          f"launches={launches.get('moe_gemm', 0)} by variant {by_var},"
          f"routed rows={int(rows.sum())},expert_load_max={load}")
    if (route == 0 or route % n_moe
            or launches.get("moe_gemm", 0) != 2 * route
            or not by_var.get("tile") or not by_var.get("small_m")):
        fail(f"{cfg.name}: moe launches {route} / {by_var} are not one "
             f"routing and two products a MoE layer a call in both "
             f"variants")


def drive_few(dev, arch: str) -> dict:
    """Serve FEW_REQUESTS requests (prompts cycling over FEW_PROMPTS,
    SERVE_NEW new tokens) of ``arch`` at full width through the threaded
    executor; returns their launches."""
    import gc
    import torch
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models import build_model
    from repro_torch.runtime import RDLBServeExecutor
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    reqs = serve_requests(cfg.vocab_size, FEW_REQUESTS, FEW_PROMPTS[arch])
    ex = RDLBServeExecutor(model, params, spec=api.serve_spec(
        technique="SS", n_workers=4, threaded=True))
    dispatch.reset_launches()
    t0 = time.perf_counter()
    st = ex.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dispatch.launches()
    variants = dispatch.variant_launches("flash_attention")
    ok = all(r.output is not None and r.output.shape == (SERVE_NEW,)
             and ((r.output >= 0) & (r.output < cfg.vocab_size)).all()
             for r in reqs)
    print(f"serve,{arch},requests={len(reqs)},prompts="
          f"{[len(r.prompt) for r in reqs]},hung={st.hung},"
          f"wall_s={wall:.4f},head_dim={cfg.head_dim},"
          f"group={cfg.n_heads // cfg.n_kv_heads},launches={launches},"
          f"flash_attention by variant={variants}")
    if st.hung or not ok:
        fail(f"{arch}: serving returned malformed or missing outputs")
    check_sites(arch, launches, FAMILY_SITES[arch])
    # paligemma's bf16 prefills at head dim 256 run on the tensor cores
    if (arch == "paligemma-3b"
            and variants.get("wgmma", 0) != launches["flash_attention"]):
        fail(f"{arch}: flash_attention launches by variant {variants}, "
             f"not all wgmma")
    del model, params, ex
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_against_cpu(dev, arch: str) -> None:
    """A float32 copy of ``arch`` cut to 2 layers (deepseek: layer 0
    dense, layer 1 MoE), full width, on the card and on the CPU: the same
    greedy tokens for one short prompt, and the last logits of the
    forward and of the prefill within CPU_LOGIT_TOL; the card's forward
    launches flash_attention once a layer."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.runtime.serve_executor import FusedGenerator
    cfg = get_config(arch).replace(n_layers=2, dtype="float32")
    model = build_model(cfg)
    params = model.init(1, device=dev)
    host = tree_map(lambda t: t.cpu(), params)
    prompt = np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(1, SERVE_PROMPTS[0])).astype(np.int32)
    gen = FusedGenerator(model)
    toks = [gen(p, prompt, SERVE_NEW) for p in (params, host)]
    tokens = torch.from_numpy(prompt)
    with torch.inference_mode():
        before = dispatch.launches("flash_attention")
        fwd = [model.forward(p, tokens.to(d))[0][:, -1].float().cpu()
               for p, d in ((params, dev), (host, "cpu"))]
        n_attn = dispatch.launches("flash_attention") - before
        pre = [model.prefill(p, model.init_cache(1, tokens.shape[1],
                                                 device=d),
                             tokens.to(d))[0][:, -1].float().cpu()
               for p, d in ((params, dev), (host, "cpu"))]
    atol, rtol = CPU_LOGIT_TOL
    errs = []
    for label, (a, b) in (("forward", fwd), ("prefill", pre)):
        e = float((a - b).abs().max())
        errs.append(e)
        if not bool(((a - b).abs() <= atol + rtol * b.abs()).all()):
            fail(f"{arch} float32 2 layers: {label} logits on the card "
                 f"differ from the CPU's by up to {e}")
    same = int((toks[0] == toks[1]).sum())
    print(f"check,{arch},float32 2 layers (layer 0 dense, layer 1 MoE),"
          f"card vs CPU: tokens equal {same}/{toks[0].size},"
          f"forward max_abs_err={errs[0]},prefill max_abs_err={errs[1]},"
          f"tolerance={atol}+{rtol}*|cpu|,flash_attention launches in the "
          f"card's forward={n_attn}")
    if same != toks[0].size:
        fail(f"{arch} float32 2 layers: greedy tokens on the card differ "
             f"from the CPU's")
    if n_attn != cfg.n_layers:
        fail(f"{arch}: the MLA forward launched flash_attention {n_attn} "
             f"times, not once a layer")
    del model, params, host
    gc.collect()
    torch.cuda.empty_cache()


# The kernels each smoke config's forward and decode launch on the card,
# by family (the others': flash_attention and flash_decode); MLA decodes
# in its absorbed form, and the vlm forward's prefix-LM mask takes the
# dense path.
SMOKE_SITES = {"rwkv": ("wkv6_batched", "wkv6_decode"),
               "moe": ("flash_attention",), "vlm": ("flash_decode",)}


def smoke_gaps(dev, arch: str) -> dict:
    """``arch``'s smoke config in float32 on the card against the CPU:
    forward logits, three greedy decode steps, one loss and its gradients
    (aux and MTP included).  Returns the gaps (logits absolute, loss and
    gradients relative), the SMOKE_SITES kernels the card's calls did not
    launch, and ``ok``: every gap within SMOKE_TOL and nothing missing.
    tests/test_torch_cuda.py holds each config to it."""
    import torch
    from repro_torch.configs import get_smoke, smoke_batch
    from repro_torch.kernels import dispatch
    from repro_torch.models import build_model, forward_logits
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.runtime.executor import value_and_grad
    cfg = get_smoke(arch).replace(dtype="float32")
    model = build_model(cfg)

    def run(p, b, dev):
        with torch.inference_mode():
            outs = [forward_logits(model, p, b)]
            cache = model.init_cache(2, 20, device=dev)
            if cfg.family == "encdec":
                cache = model.prefill_cross(p, cache, b["frames"])
            tok = b["tokens"][:, :1]
            for pos in range(3):
                lg, cache = model.decode_step(p, cache, tok, pos)
                outs.append(lg)
                tok = torch.argmax(lg[:, -1:], dim=-1)
        loss, grads = value_and_grad(lambda q, bb: model.loss(q, bb)[0], p,
                                     b)
        return [o.float().cpu() for o in outs], float(loss), [
            g.float().cpu() for g in tree_leaves(grads)]

    params = model.init(0, device="cpu")
    batch = smoke_batch(cfg, batch=2, seq=16, device="cpu")
    before = dispatch.launches()
    card = run(tree_map(lambda t: t.to(dev), params),
               {k: v.to(dev) for k, v in batch.items()}, dev)
    torch.cuda.synchronize()
    after = dispatch.launches()
    cpu = run(params, batch, "cpu")
    atol, rtol = SMOKE_TOL["logits"]
    gaps = dict(
        logits=max(float((a - b).abs().max())
                   for a, b in zip(card[0], cpu[0])),
        loss=abs(card[1] - cpu[1]) / abs(cpu[1]),
        grads=max(float((a - b).abs().max())
                  / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(card[2], cpu[2])),
        missing=[site for site in SMOKE_SITES.get(
            cfg.family, ("flash_attention", "flash_decode"))
            if after.get(site, 0) <= before.get(site, 0)])
    gaps["ok"] = (all(bool(((a - b).abs() <= atol + rtol * b.abs()).all())
                      for a, b in zip(card[0], cpu[0]))
                  and gaps["loss"] <= SMOKE_TOL["loss"]
                  and gaps["grads"] <= SMOKE_TOL["grads"]
                  and not gaps["missing"])
    return gaps


def check_smoke_configs(dev) -> None:
    """All ten smoke configs on the card against the CPU (smoke_gaps)."""
    from repro_torch.configs import ARCH_IDS
    for arch in ARCH_IDS:
        g = smoke_gaps(dev, arch)
        print(f"check,smoke,{arch},card vs CPU: logits+3 decode steps "
              f"max_abs_err={g['logits']},loss rel err={g['loss']},grads "
              f"max rel err={g['grads']},kernels not launched="
              f"{g['missing']},tolerances={SMOKE_TOL}")
        if not g["ok"]:
            fail(f"{arch} smoke config: the card's logits, loss or "
                 f"gradients differ from the CPU's beyond {SMOKE_TOL}, or "
                 f"kernels {g['missing']} did not launch")


def attention_shape(dev, label: str, S: int, H: int, KV: int, D: int,
                    Dv: int, want: str, gen, dt=None) -> dict:
    """flash_attention at one causal shape of this phase's paths (bf16
    unless ``dt`` says otherwise), held to its plain version (phase 2's
    tolerance for the dtype), launched again for the same out and lse bit
    for bit (rDLB's duplicates), and timed beside its bound and SDPA (K/V
    repeated to H heads); a wgmma shape also times the fp32 variant on
    the same inputs (``fp32_ms``), the before of its redesign."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import flash_attention as kf
    dt = dt or torch.bfloat16
    q = torch.randn((1, S, H, D), generator=gen).to(dev, dt)
    k = torch.randn((1, S, KV, D), generator=gen).to(dev, dt)
    v = torch.randn((1, S, KV, Dv), generator=gen).to(dev, dt)
    out, lse = kf.flash_attention_forward(q, k, v, causal=True)
    variant = dispatch.status("flash_attention").get("variant")
    again = kf.flash_attention_forward(q, k, v, causal=True)
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        fail(f"flash_attention ({label}): two launches on the same inputs "
             f"differ")
    pout, _ = kf.flash_attention_forward_plain(q, k, v, causal=True)
    d = (out.float() - pout.float()).abs()
    if dt == torch.float32:
        tol, peak = 1e-5, PEAK_FP32
    else:
        tol = 1e-4 + 2.0 ** -7 * pout.float().abs() + kf.bf16_p_bound(
            q, k, v, causal=True)
        peak = PEAK_BF16
    e = float(d.max())
    if variant != want or not bool((d <= tol).all()):
        fail(f"flash_attention ({label}) ran {variant} (want {want}) or "
             f"differs from its plain version by {e}")
    size = q.element_size()
    n_bytes = size * (q.numel() + k.numel() + v.numel() + H * S * Dv) \
        + 4 * H * S
    b, by = bound_ms(n_bytes, attention_ops(1, H, S, D, Dv, True),
                     peak=peak)
    ms = graph_ms(lambda: kf.flash_attention_forward(q, k, v, causal=True),
                  20)
    g = H // KV
    qh, kh, vh = (t.transpose(1, 2) for t in (
        q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = call_ms(lambda: sdpa(qh, kh, vh, is_causal=True), 20)
    name = str(dt).replace("torch.", "")
    row = dict(shape=f"{label}: q ({1},{S},{H},{D}), k ({1},{S},{KV},{D}), "
                     f"v Dv={Dv} {name}, causal", variant=variant,
               max_abs_err=e, ms=ms, bound_ms=b, bound_by=by, library_ms=lib)
    if variant == "wgmma":
        scale = D ** -0.5
        row["fp32_ms"] = graph_ms(lambda: kf._attention_cuda(
            q, k, v, True, scale, variant="fp32"), 20)
    print(f"flash_attention,{label},{name},variant={variant},max_abs_err="
          f"{e},ms={ms},fp32_ms={row.get('fp32_ms')},bound_ms={b} ({by}),"
          f"sdpa_ms={lib},repeat=bit-identical")
    return row


def served_valid(L: int, p: int, *, off: int = 0, window: int = 0):
    """The slots of an L-slot cache valid at the last decode step of a
    served request (a p-token prompt written from position ``off``, then
    SERVE_NEW - 1 decode steps): the mask gqa_decode gives flash_decode
    there, by its own slot rule (``pos % L``) and validity rule."""
    import torch
    last = off + p + SERVE_NEW - 2
    pos = torch.arange(max(off, last - L + 1), last + 1)
    cpos = torch.full((L,), -1, dtype=torch.int64)
    cpos[pos % L] = pos
    ok = (cpos >= 0) & (cpos <= last)
    if window:
        ok &= cpos > last - window
    return ok


def decode_shape(dev, label: str, H: int, KV: int, D: int, valid,
                 gen) -> dict:
    """flash_decode at one B = 1 row of a serving path (an L-slot cache,
    ``valid`` its (L,) slot mask), held to its plain version (phase 2's
    bf16 tolerance) and timed beside its bound and SDPA."""
    import torch
    from repro_torch.kernels import flash_attention as kf
    dt = torch.bfloat16
    L, n_valid = valid.numel(), int(valid.sum())
    q = torch.randn((1, H, D), generator=gen).to(dev, dt)
    k, v = (torch.randn((1, L, KV, D), generator=gen).to(dev, dt)
            for _ in range(2))
    ok = valid.to(dev)
    got = kf.flash_decode_gqa(q, k, v, ok).float()
    want = kf.flash_decode_gqa_plain(q, k, v, ok).float()
    e = float((got - want).abs().max())
    if not bool(((got - want).abs() <= 1e-4 + 2.0 ** -7 * want.abs()
                 ).all()):
        fail(f"flash_decode ({label}) differs from its plain version by {e}")
    n_bytes = 2 * (q.numel() + 2 * KV * n_valid * D + H * D) + L
    b, by = bound_ms(n_bytes, flash_decode_ops(H, n_valid, D, D))
    ms = graph_ms(lambda: kf.flash_decode_gqa(q, k, v, ok), 100)
    g = H // KV
    ks, vs = (x.repeat_interleave(g, dim=2).transpose(1, 2)[0]
              for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = call_ms(lambda: sdpa(q[0][:, None], ks, vs,
                               attn_mask=ok[None, :]), 100)
    row = dict(shape=f"{label}: cache (1,{L},{KV},{D}) bf16, {H} query "
                     f"rows, {n_valid} slots valid", max_abs_err=e, ms=ms,
               bound_ms=b, bound_by=by, library_ms=lib,
               cluster=kf.decode_splits(L))
    print(f"flash_decode,{label},B=1,L={L},valid={n_valid},"
          f"cluster={kf.decode_splits(L)},max_abs_err={e},ms={ms},"
          f"bound_ms={b} ({by}),sdpa_ms={lib}")
    return row


def family_kernel_shapes(dev, rows: dict) -> None:
    """The two attention kernels at the shapes phase 6's serving drives
    launch them at, for each prompt length they serve (SERVE_PROMPTS;
    whisper FEW_PROMPTS):
    flash_decode at each request's last step (B = 1) on hymba's windowed
    and global caches (the prompt written after the meta offset),
    paligemma's (D = 256, g = 8, the text after the patch slots) and
    whisper's (D = 64); flash_attention at hymba's global-layer and
    paligemma's prompt prefills.  And flash_attention at MLA's forward
    (D = 192, Dv = 128): at the 2-layer check's prompt, which
    check_against_cpu launches, and at the 1000-token prompt length
    (model.forward and loss; the serving path's prefill launches it
    too).  Added to the rows' ``shapes``."""
    import torch
    from repro_torch.configs import get_config
    gen = torch.Generator().manual_seed(9)
    hy, pg = get_config("hymba-1.5b"), get_config("paligemma-3b")
    wh, ds = get_config("whisper-tiny"), get_config("deepseek-v2-lite-16b")
    meta, win, patch = hy.n_meta_tokens, hy.sliding_window, pg.n_patch_tokens
    dec = rows["flash_decode"].setdefault("shapes", [])
    att = rows["flash_attention"].setdefault("shapes", [])
    for p in SERVE_PROMPTS:
        n = p + SERVE_NEW
        dec += [
            decode_shape(dev, f"hymba-1.5b windowed layer, {p}-token "
                         f"prompt", hy.n_heads, hy.n_kv_heads, hy.head_dim,
                         served_valid(min(win, n + meta), p, off=meta,
                                      window=win), gen),
            decode_shape(dev, f"hymba-1.5b global layer, {p}-token prompt",
                         hy.n_heads, hy.n_kv_heads, hy.head_dim,
                         served_valid(n + meta, p, off=meta), gen),
            decode_shape(dev, f"paligemma-3b, {p}-token prompt",
                         pg.n_heads, pg.n_kv_heads, pg.head_dim,
                         served_valid(n + patch, p, off=patch), gen)]
        if p in FEW_PROMPTS["whisper-tiny"]:
            dec.append(decode_shape(dev, f"whisper-tiny, {p}-token prompt",
                                    wh.n_heads, wh.n_kv_heads, wh.head_dim,
                                    served_valid(n, p), gen))
        att += [
            attention_shape(dev, f"hymba-1.5b global-layer prefill, {p} "
                            f"tokens", p, hy.n_heads, hy.n_kv_heads,
                            hy.head_dim, hy.head_dim, "wgmma", gen),
            attention_shape(dev, f"paligemma-3b prefill, {p} tokens", p,
                            pg.n_heads, pg.n_kv_heads, pg.head_dim,
                            pg.head_dim, "wgmma", gen)]
    mla = ds.nope_head_dim + ds.rope_head_dim
    for S, dt, what, want in (
            (SERVE_PROMPTS[0], torch.float32, "the 2-layer check's forward",
             "fp32"),
            (SERVE_PROMPTS[-1], torch.bfloat16,
             "prefill (serving) and forward at the longest prompt",
             "wgmma")):
        att.append(attention_shape(dev, f"deepseek-v2-lite-16b MLA {what}",
                                   S, ds.n_heads, ds.n_heads, mla,
                                   ds.v_head_dim, want, gen, dt))


def drive_families(dev, rows: dict) -> None:
    """Phase 6: the other model families (see FAMILY_ARCHS)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for site in ("flash_decode", "flash_attention", "moe_route",
                 "moe_gemm"):
        rows[site]["launches_families"] = {}
    for arch in FAMILY_ARCHS:
        launches = drive_family(dev, arch)
        for site in FAMILY_SITES[arch]:
            rows[site]["launches_families"][arch] = launches[site]
        if arch == "hymba-1.5b":
            same = check_plain_tokens(dev, arch)
            print(f"check,{arch},float32 2 layers (layer 0 global, layer 1 "
                  f"windowed): kernel tokens equal plain tokens {same}")
        else:
            check_against_cpu(dev, arch)
    for arch in FEW_ARCHS:
        launches = drive_few(dev, arch)
        for site in FAMILY_SITES[arch]:
            rows[site]["launches_families"][arch] = launches[site]
    family_kernel_shapes(dev, rows)
    check_smoke_configs(dev)
    print(f"families,seconds={time.perf_counter() - t0:.1f}")


# ------------------------------------------------------------ phase 7
# The batched simulator (core/devicesim) at the reference's benchmark
# sizes: benchmarks/fig_scale.py's device_sweep_point (B elements cycling
# the four fixed-chunk techniques over P workers and N unit tasks of t
# seconds) and one cell of benchmarks/fig4_resilience.py's monte_carlo
# per k (paired fail-stop draws of k victims, DRAWS a technique, all in
# one call).  Then an adaptive virtual run (ADAPTIVE_* below) whose
# portfolio forecasts batch on the card, against the same run forecast
# on the scalar engine.
SCALE_TECHS = ("SS", "STATIC", "mFSC", "FSC")
SCALE = dict(P=1024, N=1 << 17, B=1024, t=0.01, h=1e-6)
MC_TECHS = ("SS", "mFSC", "FSC")
MC = dict(P=32, N=256, t=0.01, h=1e-4, draws=10_000, cells=(1, 16, 31),
          seed=0)
MC_SAMPLED = 32                  # draws a technique held to the engine
ADAPTIVE_P, ADAPTIVE_N, ADAPTIVE_EVERY = 64, 8192, 8
SIM_ATOL = 1e-9                  # t_par, absolute (float64 both sides)


def sim_spec(tech: str, P: int, h: float):
    from repro_torch import api
    from repro_torch.core import faults
    return api.RunSpec(
        scheduling=api.SchedulingSpec(technique=tech),
        cluster=api.ClusterSpec.from_scenario(faults.baseline(P)),
        execution=api.ExecutionSpec(h=h))


def draw_failures(rng, P: int, k: int, t_est: float, draws: int):
    """``draws`` i.i.d. fail-stop draws as benchmarks/fig4_resilience.py
    makes them: k distinct victims among workers 1..P-1, instants uniform
    over [0.05, 0.95] t_est; [draws, P], inf = survives."""
    import numpy as np
    keys = rng.random((draws, P - 1))
    victims = np.argpartition(keys, min(k, P - 2), axis=1)[:, :k] + 1
    times = rng.uniform(0.05 * t_est, 0.95 * t_est, size=(draws, k))
    fail = np.full((draws, P), np.inf)
    np.put_along_axis(fail, victims, times, axis=1)
    return fail


def same_t_par(a, b) -> bool:
    import numpy as np
    a, b = np.asarray(a, float), np.asarray(b, float)
    return bool(np.array_equal(np.isinf(a), np.isinf(b))
                and np.all(np.abs(a[np.isfinite(b)] - b[np.isfinite(b)])
                           <= SIM_ATOL))


def check_same_batch(label: str, got, want) -> None:
    """Every field of two DeviceBatchResults: floats within SIM_ATOL with
    infinities in the same places, flags and integers identical."""
    import dataclasses

    import numpy as np
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        same = (same_t_par(a, b) if a.dtype.kind == "f"
                else np.array_equal(a, b))
        if not same:
            fail(f"{label}: field {f.name} of the card's batch differs from "
                 f"the CPU's")


def profile_sim(label: str, fn, wall: float) -> dict:
    """One more call of ``fn`` under torch.profiler: the kernels it
    launched, the device's busy seconds beside ``wall`` (the same call's
    unprofiled seconds), and the host ops that take most time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    averages = prof.key_averages()
    kernels = device_events(prof, averages)
    busy = sum(device_us(e) for e in kernels) / 1e6
    host = sorted(averages, key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:5]
    out = dict(kernels=sum(e.count for e in kernels), device_busy_s=busy,
               busy_share=busy / wall,
               top_host_ops=[(e.key, e.count,
                              round(e.self_cpu_time_total / 1e3, 3))
                             for e in host])
    print(f"devicesim,{label},profiled,{json.dumps(out)}")
    return out


def devicesim_scale(dev) -> dict:
    """fig_scale's device sweep point on the card: every element valid,
    each technique's t_par within rtol 1e-12, atol 1e-9 of the scalar
    engine and its assignment and duplicate counts equal."""
    import numpy as np
    from repro_torch import api
    from repro_torch.core import devicesim
    P, N, B, t, h = (SCALE[k] for k in ("P", "N", "B", "t", "h"))
    tt = np.full(N, t)
    lows, scalar, loop_s = [], [], []
    for tech in SCALE_TECHS:
        spec = sim_spec(tech, P, h)
        lo, why = devicesim.lower_run(spec, tt)
        if lo is None:
            fail(f"devicesim: {tech} at P={P} does not lower: {why}")
        lows.append(lo)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            r = api.simulate(spec, tt)
            best = min(best, time.perf_counter() - t0)
        loop_s.append(best)
        scalar.append(r)
    tech_of = np.arange(B, dtype=np.int32) % len(SCALE_TECHS)
    t0 = time.perf_counter()
    devicesim.simulate_many(lows, tech_of=tech_of, device=dev)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = devicesim.simulate_many(lows, tech_of=tech_of, device=dev)
    warm = time.perf_counter() - t0
    prof = profile_sim("fig_scale", lambda: devicesim.simulate_many(
        lows, tech_of=tech_of, device=dev), warm)
    if not res.valid.all():
        fail(f"devicesim: {int((~res.valid).sum())} of {B} fig_scale "
             f"elements came back invalid in their home regime")
    for u, (tech, r) in enumerate(zip(SCALE_TECHS, scalar)):
        sel = tech_of == u
        if not np.allclose(res.t_par[sel], r.t_par, rtol=1e-12,
                           atol=SIM_ATOL):
            fail(f"devicesim: {tech} t_par {res.t_par[sel][0]} against "
                 f"the scalar engine's {r.t_par}")
        if not ((res.n_assignments[sel] == r.n_assignments).all()
                and (res.n_duplicates[sel] == r.n_duplicates).all()):
            fail(f"devicesim: {tech} counters differ from the scalar "
                 f"engine's")
        print(f"devicesim,fig_scale,{tech},chunk={lows[u].chunk},"
              f"chunks={lows[u].n_chunks},t_par={r.t_par},"
              f"assignments={r.n_assignments},"
              f"duplicates={r.n_duplicates},scalar_s={loop_s[u]}")
    per_sim = sum(loop_s) / len(loop_s)
    out = dict(P=P, N=N, B=B, h=h, cold_s=cold, warm_s=warm,
               loop_per_sim_s=per_sim, loop_est_s=per_sim * B,
               kernels=prof["kernels"], busy_share=prof["busy_share"])
    print(f"devicesim,fig_scale,{json.dumps(out)}")
    return out


def devicesim_monte_carlo(dev) -> list:
    """fig4_resilience's Monte-Carlo cells on the card: invalid elements
    re-run on the scalar engine (counted), MC_SAMPLED draws a technique
    equal to the scalar engine, the whole batch equal to the CPU's."""
    import numpy as np
    from repro_torch import api
    from repro_torch.core import devicesim, faults
    P, N, t, h, draws = (MC[k] for k in ("P", "N", "t", "h", "draws"))
    times = np.full(N, t)
    specs = [sim_spec(tech, P, h) for tech in MC_TECHS]
    lows = [devicesim.lower_run(s, times)[0] for s in specs]
    base = devicesim.simulate_many(lows, device=dev)
    if not base.valid.all():
        fail("devicesim: a failure-free Monte-Carlo base run is invalid")
    t_est = float(base.t_par.max())
    nt = len(MC_TECHS)
    tech_of = np.repeat(np.arange(nt, dtype=np.int32), draws)
    cells = []
    for k in MC["cells"]:
        fail_t = draw_failures(np.random.default_rng([MC["seed"], k]), P, k,
                               t_est, draws)
        kw = dict(tech_of=tech_of, fail_times=np.tile(fail_t, (nt, 1)))
        t0 = time.perf_counter()
        res = devicesim.simulate_many(lows, device=dev, **kw)
        sec = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = devicesim.simulate_many(lows, device="cpu", **kw)
        cpu_sec = time.perf_counter() - t0
        check_same_batch(f"devicesim MC k={k}", res, cpu)

        def scalar(b):
            t_ix, d = divmod(int(b), draws)
            prof = [faults.PEProfile(
                fail_time=None if np.isinf(f) else float(f))
                for f in fail_t[d]]
            return api.simulate(specs[t_ix].replace(
                cluster=api.ClusterSpec.from_scenario(
                    faults.Scenario(f"mc_{k}_{d}", prof))), times)

        t_fail = np.where(res.hung, np.inf, res.t_par)
        bad = np.flatnonzero(~res.valid)
        for b in bad:                        # exact: the scalar engine
            t_fail[b] = scalar(b).t_par
        pick = np.random.default_rng([MC["seed"], k, 1])
        for u, tech in enumerate(MC_TECHS):
            ok = np.flatnonzero(res.valid & (tech_of == u))
            for b in pick.choice(ok, size=min(MC_SAMPLED, len(ok)),
                                 replace=False):
                r = scalar(b)
                if not (same_t_par(res.t_par[b], r.t_par)
                        and res.n_duplicates[b] == r.n_duplicates
                        and res.n_assignments[b] == r.n_assignments
                        and res.wasted_tasks[b] == r.wasted_tasks):
                    fail(f"devicesim MC k={k} {tech} draw {b % draws}: "
                         f"t_par {res.t_par[b]} against the scalar "
                         f"engine's {r.t_par}, or its counters differ")
        cell = dict(k=k, elements=len(tech_of), seconds=sec,
                    cpu_seconds=cpu_sec, invalid=len(bad),
                    hung=int(np.isinf(t_fail).sum()),
                    mean_t_par={tech: float(t_fail[tech_of == u].mean())
                                for u, tech in enumerate(MC_TECHS)})
        print(f"devicesim,monte_carlo,{json.dumps(cell)}")
        cells.append(cell)
    return cells


def devicesim_adaptive() -> dict:
    """An adaptive virtual run (mFSC, DEVICE_PORTFOLIO) with device_sweep
    on (forecasts batched on the default device, the card) and off: the
    same decisions, predictions within 1e-7, and at least one batch on
    the card (counts set to 0 just before the run, read just after)."""
    import numpy as np
    from repro_torch import api
    from repro_torch.core import devicesim
    tt = np.ones(ADAPTIVE_N)

    def run(device_sweep: bool):
        spec = sim_spec("mFSC", ADAPTIVE_P, 1e-4).replace(
            adaptive=api.AdaptiveSpec(
                enabled=True, device_sweep=device_sweep,
                decision_every_chunks=ADAPTIVE_EVERY,
                portfolio=api.DEVICE_PORTFOLIO))
        t0 = time.perf_counter()
        r = api.simulate(spec, tt)
        return r, time.perf_counter() - t0

    devicesim.reset_batch_calls()
    on, on_s = run(True)
    calls = devicesim.batch_calls()
    off, off_s = run(False)
    da, db = on.adaptive_decisions, off.adaptive_decisions
    if len(da) != len(db) or len(da) < 2:
        fail(f"adaptive: {len(da)} decisions with device_sweep, {len(db)} "
             f"without (need the same, at least 2)")
    for a, b in zip(da, db):
        if (a.chosen, a.swapped, a.n_remaining) != \
                (b.chosen, b.swapped, b.n_remaining) or \
                a.predictions.keys() != b.predictions.keys() or \
                any(abs(a.predictions[c] - b.predictions[c]) > 1e-7
                    for c in a.predictions):
            fail(f"adaptive: decision at t={a.t} differs: {a.chosen} "
                 f"{a.predictions} against {b.chosen} {b.predictions}")
    if not same_t_par(on.t_par, off.t_par):
        fail(f"adaptive: t_par {on.t_par} against {off.t_par}")
    if calls.get("cuda", 0) < 1 or calls.get("cpu", 0):
        fail(f"adaptive: batched forecasts by device {calls}; need at "
             f"least one on the card and none on the CPU")
    out = dict(P=ADAPTIVE_P, N=ADAPTIVE_N, decisions=len(da),
               chosen=[d.chosen for d in da], card_batches=calls["cuda"],
               device_sweep_s=on_s, scalar_sweep_s=off_s, t_par=on.t_par)
    print(f"devicesim,adaptive,{json.dumps(out)}")
    return out


def drive_devicesim(dev) -> dict:
    """Phase 6: the batched simulator and the adaptive policy it feeds."""
    return dict(fig_scale=devicesim_scale(dev),
                monte_carlo=devicesim_monte_carlo(dev),
                adaptive=devicesim_adaptive())


# ------------------------------------------------------------ phase 8
# Process mode (repro_torch.cluster): PROC_WORKERS worker processes, each
# a spawned interpreter with a CUDA context of its own, the kernels built
# once by the master before it spawns them.  Kills and freezes are real
# signals: fail_after_tasks=1 SIGKILLs a worker at its next assignment
# after one task, so it dies mid-run holding a chunk; hang_time SIGSTOPs
# one.  Every worker sleeps PROC_SLEEP[app] a task (sleep_per_task, a
# declared perturbation realised in the child), so each victim is at
# work while its siblings still are.  olmo-1b serves at full depth;
# it trains at PROC_TRAIN_DEPTH layers, where one task's gradients (bf16,
# the parameters' size: 0.74 GB) fit the transport's 1 GiB frame.
PROC_WORKERS = 4
PROC_TIMEOUTS = dict(stall_timeout=60.0, wall_timeout=600.0)
PROC_SLEEP = {"mandelbrot": 0.05, "psia": 1e-4, "serve": 0.5}
PROC_TRAIN_DEPTH = 4
PROC_HANG_AFTER = 2.0            # s after the slowest child's first task
PROC_MEM_SLACK = 256 << 20       # bytes of card memory the phase may keep


def proc_spec(technique: str, workers, name: str, n_tasks=None):
    from repro_torch import api
    return api.RunSpec(
        scheduling=api.SchedulingSpec(technique=technique),
        cluster=api.ClusterSpec(n_workers=PROC_WORKERS,
                                workers=tuple(workers), name=name),
        execution=api.ExecutionSpec(mode="process", h=0.0,
                                    horizon=100000.0, **PROC_TIMEOUTS),
        n_tasks=n_tasks, name=name)


@contextlib.contextmanager
def card_peak(out: dict):
    """The card's peak use (total less the least free memory, sampled
    every 20 ms, all processes) while the block runs, into
    ``out["card_peak_GB"]``."""
    import threading
    import torch
    free0, total = torch.cuda.mem_get_info()
    least = [free0]
    stop = threading.Event()

    def sample():
        while not stop.wait(0.02):
            least[0] = min(least[0], torch.cuda.mem_get_info()[0])

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        yield
    finally:
        stop.set()
        th.join()
        out["card_peak_GB"] = (total - least[0]) / 1e9


def proc_report(label: str, sites, stats: dict, card: dict) -> dict:
    """The last process-mode run's numbers, printed; fails unless at
    least one child reported and every child that reported ran each of
    ``sites`` through ``cuda`` with launches > 0.  Returns them with the
    children's launches summed per site (``launches``)."""
    from repro_torch import cluster
    run = cluster.runs()[-1]
    children, total = {}, {}
    for wid, c in sorted(run["children"].items()):
        rec = dict(pid=c["pid"],
                   spawn_to_first_assign_s=c["spawn_to_first_assign_s"])
        k = c["kernels"]
        if k is not None:
            for site in sites:
                if (k["launches"].get(site, 0) <= 0 or k["status"].get(
                        site, {}).get("path") != "cuda"):
                    fail(f"process {label}: child {wid} (pid {c['pid']}) "
                         f"reports {site} as {k['status'].get(site)} with "
                         f"launches {k['launches']}")
            for site, n in k["launches"].items():
                total[site] = total.get(site, 0) + n
            rec.update(launches=k["launches"],
                       peak_GB=(k["peak_bytes"] or 0) / 1e9)
        children[wid] = rec
    if not total:
        fail(f"process {label}: no child reported a kernel launch")
    out = dict(stats, wall_s=run["wall_s"],
               payload_bytes=run["payload_bytes"], **card,
               chaos=[(round(e["t"], 3), e["wid"], e["action"])
                      for e in run["chaos"]],
               children=children)
    print(f"process,{label},{json.dumps(out)}")
    out["launches"] = total
    return out


def counting_backend(base):
    """``base`` (a backend class) counting its commits per task id."""
    class Counting(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.commits = {}

        def commit(self, chunk, wid, payload, newly):
            for t in newly:
                self.commits[t] = self.commits.get(t, 0) + 1
            super().commit(chunk, wid, payload, newly)
    return Counting


def check_exactly_once(label: str, st, backend, n: int, kills: int) -> dict:
    kill_events = [e for e in st.chaos_events
                   if e.action in ("kill", "kill_by_count")]
    if st.hung or st.n_finished != n:
        fail(f"process {label}: finished {st.n_finished}/{n} tasks")
    if backend.commits != {t: 1 for t in range(n)}:
        fail(f"process {label}: tasks not committed exactly once")
    if len(kill_events) != kills or len(st.survivors) != PROC_WORKERS - kills:
        fail(f"process {label}: {len(kill_events)} kills, survivors "
             f"{st.survivors}; expected {kills} kills")
    return dict(n_duplicates=st.n_duplicates, wasted=st.wasted_tasks,
                survivors=st.survivors, kills=len(kill_events))


def process_apps(img, spins) -> dict:
    """Mandelbrot (FAC over its 64 tiles, P - 1 children SIGKILLed) and
    PSIA (FAC over 20,000 points, one child SIGKILLed) in process mode;
    the image and the spin images must equal phase 3's threaded results
    bit for bit, every task committed exactly once.  Returns each app's
    report."""
    import functools

    import numpy as np
    from repro_torch import api, cluster
    from repro_torch.apps import mandelbrot, psia
    from repro_torch.core.engine import WorkerBackend
    from repro_torch.runtime import FnBackend
    out = {}
    side, iters = mandelbrot.SIDE, mandelbrot.MAX_ITERS
    n = mandelbrot.n_tiles(side, TILE)
    sleep = PROC_SLEEP["mandelbrot"]
    spec = proc_spec("FAC", [api.WorkerSpec(sleep_per_task=sleep)]
                     + [api.WorkerSpec(sleep_per_task=sleep,
                                       fail_after_tasks=1)]
                     * (PROC_WORKERS - 1), "mandelbrot", n)
    backend = counting_backend(FnBackend)(task_fn=functools.partial(
        mandelbrot.compute_tile, side=side, tile=TILE, max_iters=iters,
        device="cuda"))
    card = {}
    with card_peak(card):
        st = api.execute(spec, backend)
    stats = check_exactly_once("mandelbrot", st, backend, n,
                               PROC_WORKERS - 1)
    if not np.array_equal(mandelbrot.assemble(backend.results, side=side,
                                              tile=TILE), img):
        fail("process mandelbrot: the image differs from phase 3's")
    out["mandelbrot"] = proc_report("mandelbrot", ["mandelbrot"], stats,
                                    card)

    class Spins(WorkerBackend):            # the master side: commits only
        def __init__(self):
            self.results = {}

        def commit(self, chunk, wid, payload, newly):
            for t in newly:
                self.results[t] = payload[t]

    n = psia.PAPER_N
    sleep = PROC_SLEEP["psia"]
    spec = proc_spec("FAC", [api.WorkerSpec(sleep_per_task=sleep,
                                            fail_after_tasks=(
                                                1 if w == 1 else None))
                             for w in range(PROC_WORKERS)], "psia", n)
    backend = counting_backend(Spins)()
    runner = cluster.ChunkRunner(functools.partial(
        psia.compute_tasks, n=n, cloud_n=psia.CLOUD, device="cuda"))
    card = {}
    with card_peak(card):
        st = api.run(spec, api.build(spec, backend, factory=runner))
    stats = check_exactly_once("psia", st, backend, n, 1)
    if not np.array_equal(np.stack([backend.results[t] for t in range(n)]),
                          spins):
        fail("process psia: the spin images differ from phase 3's")
    out["psia"] = proc_report("psia", ["spin_image"], stats, card)
    print("process: mandelbrot and psia through SIGKILLs equal phase 3's "
          "threaded results bit for bit, every task committed once")
    return out


def process_serving(dev) -> dict:
    """olmo-1b at full width and depth, bf16, seeded weights: phase 4's
    16 requests served threaded (P=4), then in process mode failure-free
    and through a SIGKILL (replica 1, after its first request) and a
    SIGSTOP (replica 2, PROC_HANG_AFTER s after the failure-free run's
    slowest child took its first request).  Tokens must be equal across
    the three.  Returns the kill/stop run's report."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import RDLBServeExecutor
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    threaded, _, wall = run_serving(model, params, failing=False)
    print(f"process,serve,threaded,layers={cfg.n_layers},wall_s={wall:.4f}")
    spec = proc_spec("SS", [api.WorkerSpec()] * PROC_WORKERS, "serve")

    def serve(spec, **kw):
        reqs = serve_requests(cfg.vocab_size)
        ex = RDLBServeExecutor(model, params, spec=spec)
        ex.slow = {w: PROC_SLEEP["serve"] for w in range(PROC_WORKERS)}
        card = {}
        with card_peak(card):
            st = ex.serve(reqs, **kw)
        if st.hung or any(r.output is None for r in reqs):
            fail(f"process serving hung={st.hung} ({kw})")
        return reqs, st, card

    calm, st, card = serve(spec)
    out = {"failure-free": proc_report(
        "serve,failure-free", ("flash_decode",), dict(
            n_duplicates=st.n_duplicates, wasted=st.wasted_requests,
            by_worker=st.by_worker), card)}
    start = max(c["spawn_to_first_assign_s"] or 0.0 for c in
                out["failure-free"]["children"].values())
    workers = [api.WorkerSpec()] * PROC_WORKERS
    workers[2] = api.WorkerSpec(hang_time=start + PROC_HANG_AFTER)
    spec = dataclasses.replace(spec, cluster=dataclasses.replace(
        spec.cluster, workers=tuple(workers)))
    hit, st, card = serve(spec, fail_at={1: 1})
    rep = proc_report("serve,kill+stop", ("flash_decode",), dict(
        n_duplicates=st.n_duplicates, wasted=st.wasted_requests,
        by_worker=st.by_worker), card)
    actions = {(w, a) for _, w, a in rep["chaos"]}
    if not {(1, "kill_by_count"), (2, "stop")} <= actions:
        fail(f"process serving: chaos {rep['chaos']}, need replica 1 "
             f"killed and replica 2 stopped")
    print(f"process,serve: replica 2 was stopped "
          f"{'after' if 'launches' in rep['children'][2] else 'before'} "
          f"its first request")
    for name, other in (("failure-free process", calm),
                        ("threaded", threaded)):
        bad = [r.rid for r, c in zip(hit, other)
               if not np.array_equal(r.output, c.output)]
        if bad:
            fail(f"process serving: requests {bad} differ from the "
                 f"{name} run's")
    print("process,serve: tokens through a SIGKILL and a SIGSTOP equal the "
          "failure-free process run's and the threaded run's bit for bit")
    del model, params
    torch.cuda.empty_cache()
    return {"kill+stop": rep, **out}


def process_training(dev) -> dict:
    """One step of olmo-1b at full width and PROC_TRAIN_DEPTH layers
    (8 x 2048 tokens, 8 tasks, P=4, FAC, adamw, exact accumulation):
    threaded, in process mode failure-free, and in process mode with
    worker 1 SIGKILLed at its assignment after its first task.  The
    process runs' parameters must be equal bit for bit; against the
    threaded step they are compared and the largest gap printed (it
    must be 0: the same per-task gradients, reduced in float32 in the
    same order, on the host instead of the card)."""
    import math

    import torch
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.data import batch_for_step
    from repro_torch.models import build_model
    from repro_torch.runtime import RDLBTrainExecutor
    cfg = get_config(TRAIN_ARCH).replace(n_layers=PROC_TRAIN_DEPTH)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    batch = batch_for_step(cfg, 0, TRAIN_BATCH, TRAIN_SEQ)
    spec = proc_spec("FAC", [api.WorkerSpec()] * PROC_WORKERS, "train",
                     TRAIN_TASKS)

    def step(spec, fail_after=None):
        ex = RDLBTrainExecutor(model, spec=spec, optimizer="adamw",
                               lr=1e-4, exact_accumulation=True)
        if fail_after is not None:
            ex.workers[1].fail_after_tasks = fail_after
        card = {}
        with card_peak(card):
            t0 = time.perf_counter()
            res = ex.train_step(params, ex.opt.init(params), batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        if res.hung or not math.isfinite(res.loss):
            fail(f"process training: hung={res.hung}, loss={res.loss}")
        stats = dict(loss=res.loss, seconds=dt,
                     n_duplicates=res.n_duplicates,
                     wasted=res.wasted_tasks, survivors=res.survivors)
        return params_on_host(res.params), stats, card

    threaded, tstats, _ = step(spec.override("execution.mode", "threaded"))
    print(f"process,train,threaded,layers={cfg.n_layers},"
          f"{json.dumps(tstats)}")
    calm, stats, card = step(spec)
    out = {"failure-free": proc_report("train,failure-free",
                                       ("flash_attention",), stats, card)}
    hit, stats, card = step(spec, fail_after=1)
    out["kill"] = proc_report("train,kill", ("flash_attention",), stats,
                              card)
    if 1 in stats["survivors"] or stats["n_duplicates"] < 1:
        fail(f"process training: worker 1 not lost or no duplicate "
             f"({stats})")
    if any(not torch.equal(a, b) for a, b in zip(hit, calm)):
        fail("process training: parameters after a SIGKILL differ from "
             "the failure-free process step's")
    gap = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(hit, threaded))
    print(f"process,train: parameters through a SIGKILL equal the "
          f"failure-free process step's bit for bit; largest gap to the "
          f"threaded step {gap}")
    if gap != 0.0:
        fail(f"process training: parameters differ from the threaded "
             f"step's by up to {gap}")
    del model, params
    torch.cuda.empty_cache()
    return out


def card_level() -> int:
    """Card memory held by no other process: free, plus what this
    process's caching allocator holds (threaded runs in this process
    keep cuBLAS workspaces there; empty_cache cannot return them)."""
    import torch
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved()


def no_children_left(level_before: int) -> None:
    """No process of ours runs cluster code any more, and the card's
    memory held by no other process (:func:`card_level`) is back within
    PROC_MEM_SLACK of its level before the phase (polled for up to 10 s:
    the driver frees a killed process's memory after it is reaped)."""
    me = str(os.getpid())
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = f.read().rsplit(")", 1)[1].split()[1]
            with open(f"/proc/{pid}/cmdline") as f:
                cmd = f.read().replace("\0", " ")
        except (FileNotFoundError, ProcessLookupError, IndexError):
            continue
        if ppid == me and "repro_torch.cluster" in cmd:
            fail(f"process mode left a child behind: {pid} {cmd}")
    deadline = time.monotonic() + 10.0
    while True:
        level = card_level()
        if level >= level_before - PROC_MEM_SLACK:
            break
        if time.monotonic() > deadline:
            fail(f"card memory after process mode: {level / 1e9:.3f} GB "
                 f"free or cached here, {level_before / 1e9:.3f} GB before "
                 f"the phase")
        time.sleep(0.2)
    print(f"process: no child left; card memory free or cached here "
          f"{level / 1e9:.3f} GB (before the phase "
          f"{level_before / 1e9:.3f} GB)")


def drive_process(dev, img, spins) -> dict:
    """Phase 8; returns the children's launches per kernel site."""
    from repro_torch import cluster
    level_before = card_level()
    cluster.reset_runs()
    apps = process_apps(img, spins)
    serve = process_serving(dev)
    train = process_training(dev)
    no_children_left(level_before)
    return {"mandelbrot": apps["mandelbrot"]["launches"]["mandelbrot"],
            "spin_image": apps["psia"]["launches"]["spin_image"],
            "flash_decode": serve["kill+stop"]["launches"]["flash_decode"],
            "flash_attention": train["kill"]["launches"]["flash_attention"]}


# ------------------------------------------------------------ phase 9
# The serving executor's other paths.  olmo-1b at full width and depth
# in bfloat16 serves one request a prompt length of EXEC_PROMPTS: GSS
# over EXEC_WORKERS threads hands out the first two (of equal length)
# as one chunk, which batch_decode decodes as one group of two, and the
# rest one by one.  The loop modes walk every prompt token through
# decode_step, so no 1000-token prompt is served here, and 5 requests,
# one of 64 tokens, keep the phase near 90 s (8 requests took 126 s, 6
# took 120 s, 5 with two of 64 tokens 98 s).  A fail-stop run loses
# worker 1 holding its first chunk (EXEC_FAIL).
EXEC_ARCH = "olmo-1b"
EXEC_PROMPTS = (37, 37, 64, 37, 37)
EXEC_WORKERS = 4
EXEC_FAIL = {1: 0}
EXEC_MODES = ((True, True), (False, True), (True, False), (False, False))
# float32 copies at 2 layers, full width: greedy tokens equal across the
# four modes, over the first EXEC_CHECK_REQUESTS requests through GSS
# over EXEC_CHECK_WORKERS threads (a first chunk of two again).  Each
# arch's (prefill site, decode site).
EXEC_CHECK_ARCHS = ("olmo-1b", "rwkv6-1.6b")
EXEC_CHECK_REQUESTS = 3
EXEC_CHECK_WORKERS = 2
EXEC_SITES = {"olmo-1b": ("flash_attention", "flash_decode"),
              "rwkv6-1.6b": ("wkv6_batched", "wkv6_decode")}


def exec_label(mode) -> str:
    batch, fused = mode
    return f"batch_decode={batch},fused_decode={fused}"


def exec_requests(vocab: int, n: int | None = None) -> list:
    """The first n (all) requests of SERVE_NEW new tokens, one a prompt
    length of EXEC_PROMPTS, seeded tokens."""
    import numpy as np
    from repro_torch.runtime import Request
    rng = np.random.default_rng(4)
    return [Request(i, rng.integers(0, vocab, size=p).astype(np.int32),
                    max_new_tokens=SERVE_NEW)
            for i, p in enumerate(EXEC_PROMPTS[:n])]


class ModelCalls:
    """Counts a model's ``prefill`` and ``decode_step`` calls, from any
    thread, by wrapping both on the instance, and, under ``"groups"``,
    the prompt length of each group a watched executor's fused generator
    served (:meth:`watching`)."""

    def __init__(self, model):
        import threading
        self._lock = threading.Lock()
        self.n = {"prefill": 0, "decode_step": 0, "groups": []}
        for name in ("prefill", "decode_step"):
            setattr(model, name, self._counting(name, getattr(model, name)))

    def _counting(self, name: str, fn):
        def call(*args, **kwargs):
            with self._lock:
                self.n[name] += 1
            return fn(*args, **kwargs)
        return call

    @contextlib.contextmanager
    def watching(self, ex):
        """For the block, each group ``ex`` hands its fused generator (if
        it has one) adds its prompt length to ``"groups"``."""
        gen = ex._fused
        if gen is None:
            yield
            return

        def call(params, prompts, max_new):
            with self._lock:
                self.n["groups"].append(prompts.shape[1])
            return gen(params, prompts, max_new)
        ex._fused = call
        try:
            yield
        finally:
            ex._fused = gen

    def take(self) -> dict:
        """The counts since the last take, then set to 0."""
        with self._lock:
            out = self.n
            self.n = {"prefill": 0, "decode_step": 0, "groups": []}
        return out


def exec_launch_problems(sites, n_layers: int, fused: bool, calls: dict,
                         launches: dict, *, graphed: bool = False,
                         captures: int | None = None,
                         segments: tuple | None = None) -> list:
    """What is wrong with one run's launches, from the model calls it
    made: each layer launches the prefill site once a prefill call and
    the decode site once a decode step, nothing else launches, the loop
    modes call no prefill and every mode decodes.  A loop mode runs one
    decode step a ``decode_step`` call; a fused mode runs SERVE_NEW - 1
    a prefill call (a group, every request asking for SERVE_NEW tokens)
    and calls ``decode_step`` for each of them, or, where its groups
    replay a CUDA graph of the step (``graphed``), for two in a group
    that captured the graph (step 1 and the capture) and none in one
    that replayed a graph its lane kept: two a capture (``captures``,
    the run's count), or, with no count, an even number, two a group at
    most.  Where the groups prefill in segments replayed from kept
    graphs, ``segments`` = (captures, hits), the run's counts of the
    executor's ``PREFILL_CAPTURES`` and ``PREFILL_HITS``: the prefill
    site launches once a layer a segment (the eager one of a capture and
    each replay), ``prefill`` is called twice a capture (the eager
    segment and the capture) and never for a hit, the segments are
    those of ``prefill_segments`` over the prompt lengths of the groups
    served (``calls["groups"]``), and each group calls ``decode_step``
    for its SERVE_NEW - 1 steps."""
    from repro_torch.runtime.serve_executor import prefill_segments
    problems = []
    prefills = calls["prefill"] if segments is None else sum(segments)
    if (prefills > 0) != fused:
        problems.append(f"{prefills} prefills")
    steps = calls["decode_step"]
    if fused and segments is not None:
        if calls["prefill"] != 2 * segments[0]:
            problems.append(f"{calls['prefill']} prefill calls, expected "
                            f"{2 * segments[0]} (two a capture)")
        groups = calls["groups"]
        planned = sum(len(prefill_segments(S)) for S in groups)
        if prefills != planned:
            problems.append(f"{prefills} segments, expected {planned} for "
                            f"groups of prompt lengths {groups}")
        if steps != len(groups) * (SERVE_NEW - 1):
            problems.append(f"{steps} decode_step calls for {len(groups)} "
                            f"groups")
    elif fused:
        steps = calls["prefill"] * (SERVE_NEW - 1)
        got = calls["decode_step"]
        if not graphed:
            want_calls = calls["prefill"] * (SERVE_NEW - 1)
        elif captures is not None:
            want_calls = 2 * captures
        else:
            want_calls = (f"an even number up to {2 * calls['prefill']}"
                          if got % 2 or got > 2 * calls["prefill"] else got)
        if got != want_calls:
            problems.append(f"{got} decode_step calls, "
                            f"expected {want_calls}")
    if steps <= 0:
        problems.append("no decode step")
    want = {sites[0]: n_layers * prefills, sites[1]: n_layers * steps}
    want = {k: v for k, v in want.items() if v}
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        problems.append(f"launches {got}, expected {want}")
    return problems


def exec_graphed(model, params) -> bool:
    """Whether the fused modes' groups of SERVE_NEW tokens replay a CUDA
    graph of the model's decode step where its params lie."""
    from repro_torch.models.common import first_tensor
    from repro_torch.runtime.serve_executor import FusedGenerator
    return FusedGenerator(model).graphed(first_tensor(params).device,
                                         SERVE_NEW - 1)


def exec_captures() -> int:
    """Graph captures since the launch counts were last set to 0 (the
    serving executor's ``GRAPH_CAPTURES`` event)."""
    from repro_torch.kernels import dispatch
    from repro_torch.runtime.serve_executor import GRAPH_CAPTURES
    return dispatch.events(GRAPH_CAPTURES)


def exec_segments(model, params) -> tuple | None:
    """(captures, hits) of prefill segments since the launch counts were
    last set to 0 (the serving executor's ``PREFILL_CAPTURES`` and
    ``PREFILL_HITS`` events), or None where the model's groups do not
    prefill in segments where its params lie."""
    from repro_torch.kernels import dispatch
    from repro_torch.models.common import first_tensor
    from repro_torch.runtime import serve_executor as se
    if not se.FusedGenerator(model).segmented(first_tensor(params).device):
        return None
    return (dispatch.events(se.PREFILL_CAPTURES),
            dispatch.events(se.PREFILL_HITS))


def exec_serve(ex, reqs, calls: ModelCalls, **kw) -> tuple:
    """``ex.serve(reqs, **kw)`` with launch and model-call counts set to
    0 just before and read just after -> (stats, wall seconds, launches,
    calls); every request must be served, well formed."""
    from repro_torch.kernels import dispatch
    calls.take()
    dispatch.reset_launches()
    with calls.watching(ex):
        t0 = time.perf_counter()
        st = ex.serve(reqs, **kw)   # tokens reach the host: synchronised
        wall = time.perf_counter() - t0
    launches, n = dispatch.launches(), calls.take()
    vocab = ex.model.cfg.vocab_size
    for r in reqs:
        if r.output is None and not st.hung:
            fail(f"request {r.rid} not served (stats {st})")
        if r.output is not None and (r.output.shape != (r.max_new_tokens,)
                                     or not ((r.output >= 0)
                                             & (r.output < vocab)).all()):
            fail(f"request {r.rid} output malformed: {r.output}")
    return st, wall, launches, n


def exec_tokens(reqs) -> dict:
    return {r.rid: r.output for r in reqs}


def same_tokens(a: dict, b: dict) -> list:
    """rids whose tokens differ between two runs."""
    import numpy as np
    return [rid for rid in a if not np.array_equal(a[rid], b[rid])]


def exec_spec(n_workers: int = EXEC_WORKERS):
    from repro_torch import api
    return api.serve_spec(technique="GSS", n_workers=n_workers,
                          threaded=True)


def exec_mode(model, params, calls: ModelCalls, mode, sites) -> dict:
    """One (batch_decode, fused_decode) mode: a fail-stop run, then a
    failure-free one; each run's launches checked, the fail-stop run with
    a duplicate and worker 1 dead, the tokens equal bit for bit.
    Returns the failure-free tokens and the fail-stop run's launches."""
    from repro_torch.runtime import RDLBServeExecutor
    cfg, label = model.cfg, exec_label(mode)
    runs = {}
    for failing in (True, False):
        reqs = exec_requests(cfg.vocab_size)
        ex = RDLBServeExecutor(model, params, spec=exec_spec(),
                               batch_decode=mode[0], fused_decode=mode[1])
        st, wall, launches, n = exec_serve(
            ex, reqs, calls, fail_at=EXEC_FAIL if failing else None)
        print(f"exec,{cfg.name},{cfg.dtype},layers={cfg.n_layers},{label},"
              f"{'fail-stop' if failing else 'failure-free'},"
              f"requests={len(reqs)},wall_s={wall:.4f},"
              f"requests_s={len(reqs) / wall:.3f},"
              f"n_duplicates={st.n_duplicates},"
              f"wasted={st.wasted_requests},by_worker={st.by_worker},"
              f"calls={n},launches={launches}", flush=True)
        if st.hung:
            fail(f"{cfg.name} {label}: the run hung")
        problems = exec_launch_problems(
            sites, cfg.n_layers, mode[1], n, launches,
            graphed=exec_graphed(model, params), captures=exec_captures(),
            segments=exec_segments(model, params))
        if problems:
            fail(f"{cfg.name} {label}: {problems}")
        if failing and (st.n_duplicates < 1 or 1 not in ex.dead):
            fail(f"{cfg.name} {label}: the fail-stop run issued "
                 f"{st.n_duplicates} duplicates, dead {ex.dead}")
        runs[failing] = (exec_tokens(reqs), launches)
    bad = same_tokens(runs[True][0], runs[False][0])
    if bad:
        fail(f"{cfg.name} {label}: requests {bad} under a fail-stop "
             f"differ from the failure-free run")
    return {"tokens": runs[False][0], "launches": runs[True][1]}


def exec_legacy(model, params, calls: ModelCalls, tokens: dict) -> None:
    """The legacy keywords (each construction warns), serve through a
    straggler and a fail-stop in concurrent mode (the tokens of the mode
    that decodes each request alone, as SS does), the hang without rDLB,
    and ``fail_worker`` (the batched fused tokens)."""
    import warnings
    from repro_torch.runtime import RDLBServeExecutor
    vocab = model.cfg.vocab_size

    def legacy(**kw):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            ex = RDLBServeExecutor(model, params, **kw)
        if not any(issubclass(w.category, DeprecationWarning)
                   and "RDLBServeExecutor" in str(w.message) for w in seen):
            fail(f"RDLBServeExecutor({kw}) raised no DeprecationWarning")
        return ex

    ex = legacy(n_workers=3, technique="SS", concurrent=True)
    ex.slow[0] = 0.02
    reqs = exec_requests(vocab)
    st, wall, _, _ = exec_serve(ex, reqs, calls, fail_at={1: 1})
    print(f"exec,legacy,concurrent SS P=3,slow[0]=0.02,fail_at={{1: 1}}:"
          f" hung={st.hung},dead={sorted(ex.dead)},"
          f"n_duplicates={st.n_duplicates},wall_s={wall:.4f}")
    bad = same_tokens(exec_tokens(reqs), tokens[(False, True)])
    if st.hung or 1 not in ex.dead or bad:
        fail(f"concurrent legacy run: hung={st.hung}, dead={ex.dead}, "
             f"requests {bad} differ")
    ex = legacy(n_workers=2, technique="SS", rdlb_enabled=False,
                concurrent=True)
    st, wall, _, _ = exec_serve(ex, exec_requests(vocab, 4), calls,
                                fail_at={1: 0})
    print(f"exec,legacy,no rDLB,fail_at={{1: 0}}: hung={st.hung},"
          f"wall_s={wall:.4f}")
    if not st.hung:
        fail("without rDLB a fail-stop must hang the run")
    ex = RDLBServeExecutor(model, params, spec=exec_spec())
    ex.fail_worker(2)
    reqs = exec_requests(vocab)
    st, wall, _, _ = exec_serve(ex, reqs, calls)
    print(f"exec,fail_worker(2): by_worker={st.by_worker},"
          f"wall_s={wall:.4f}")
    bad = same_tokens(exec_tokens(reqs), tokens[(True, True)])
    if st.hung or st.by_worker.get(2, 0) or bad:
        fail(f"fail_worker(2): hung={st.hung}, by_worker={st.by_worker}, "
             f"requests {bad} differ")


def exec_cross_mode(dev, arch: str) -> dict:
    """A float32 copy of ``arch`` at 2 layers, full width: the four modes
    (failure-free) give the same greedy tokens through the kernels, each
    run's launches checked.  Returns the launches per mode label."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import RDLBServeExecutor
    cfg = get_config(arch).replace(n_layers=2, dtype="float32")
    model = build_model(cfg)
    params = model.init(1, device=dev)
    calls = ModelCalls(model)
    out, first = {}, None
    for mode in EXEC_MODES:
        reqs = exec_requests(cfg.vocab_size, EXEC_CHECK_REQUESTS)
        ex = RDLBServeExecutor(model, params,
                               spec=exec_spec(EXEC_CHECK_WORKERS),
                               batch_decode=mode[0], fused_decode=mode[1])
        st, wall, launches, n = exec_serve(ex, reqs, calls)
        problems = exec_launch_problems(
            EXEC_SITES[arch], cfg.n_layers, mode[1], n, launches,
            graphed=exec_graphed(model, params), captures=exec_captures(),
            segments=exec_segments(model, params))
        if st.hung or problems:
            fail(f"{arch} float32 {exec_label(mode)}: hung={st.hung} "
                 f"{problems}")
        tokens = exec_tokens(reqs)
        first = first or tokens
        bad = same_tokens(tokens, first)
        if bad:
            fail(f"{arch} float32 2 layers: requests {bad} in "
                 f"{exec_label(mode)} differ from {exec_label(EXEC_MODES[0])}")
        out[exec_label(mode)] = launches
        print(f"exec,{arch},float32,layers=2,{exec_label(mode)}: tokens "
              f"equal,wall_s={wall:.4f},launches={launches}")
    del model, params, calls
    torch.cuda.empty_cache()
    return out


def drive_executor(dev, rows: dict) -> None:
    """Phase 9: the executor's four decode modes, its legacy and
    concurrent surface, and the float32 cross-mode check; adds each
    kernel's launches per mode to its row."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(EXEC_ARCH)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    calls = ModelCalls(model)
    tokens = {}
    for mode in EXEC_MODES:
        res = exec_mode(model, params, calls, mode, EXEC_SITES[EXEC_ARCH])
        tokens[mode] = res["tokens"]
        for site in EXEC_SITES[EXEC_ARCH]:
            rows[site].setdefault("launches_executor", {})[
                exec_label(mode)] = res["launches"].get(site, 0)
    exec_legacy(model, params, calls, tokens)
    del model, params, calls
    torch.cuda.empty_cache()
    for arch in EXEC_CHECK_ARCHS:
        for label, launches in exec_cross_mode(dev, arch).items():
            for site in EXEC_SITES[arch]:
                rows[site].setdefault("launches_executor_float32", {})[
                    f"{arch},{label}"] = launches.get(site, 0)


def ptxas_entries(log: str) -> list:
    """(source, mangled kernel name, its "Used ..." line, its spill
    line) for each kernel entry in nvcc's ``-Xptxas -v`` report."""
    import re
    out, src, entry, spills = [], "", None, ""
    for line in log.splitlines():
        if line.startswith("--- "):
            src = line[4:].strip()
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spills = m.group(1), ""
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and entry is not None:
            out.append((src, entry, line.split(":", 1)[-1].strip(), spills))
            entry = None
    return out


def sass_counts(build, kernel: str) -> dict:
    """{function: {"HGMMA": n, "UTMALDG": n}}: wgmma and TMA-load
    instructions in the SASS of each of the built library's functions
    whose (mangled) name holds ``kernel`` (``cuobjdump -sass``)."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", str(build.BUILD_DIR
                                             / build.LIB_NAME)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump failed: {res.stderr.strip()[:500]}")
    counts, inside = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            inside = (counts.setdefault(name, {"HGMMA": 0, "UTMALDG": 0})
                      if kernel in name else None)
        elif inside is not None:
            for op in inside:
                inside[op] += line.count(op)
    return counts


def spill_bytes(spills: str) -> int:
    """Bytes of spill stores plus loads on a ptxas report line (0 when it
    names none)."""
    import re
    return sum(int(n) for n in re.findall(r"(\d+) bytes spill", spills))


def check_wkv6_smem(build) -> None:
    """``wkv6_batched_smem`` of the built library (ctypes) against the
    wrapper's ``_batched_smem`` at the shapes phase 2 and the serving path
    use; fails on any difference."""
    import ctypes
    from repro_torch.configs import get_config
    from repro_torch.kernels import rwkv6_scan as kw
    fn = build.library().wkv6_batched_smem
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_size_t
    dk = dv = get_config("rwkv6-1.6b").rwkv_head_dim
    for BH in sorted({bh for bh, _ in WKV_BATCHED} | {1}):
        n_col = kw.col_split(BH, dv)
        for itemsize in (2, 4):
            c_bytes = fn(dk, dv, kw.CHUNK, n_col, itemsize)
            py_bytes = kw._batched_smem(dk, dv, kw.CHUNK, n_col, itemsize)
            print(f"smem,wkv6_batched,BH={BH},n_col={n_col},"
                  f"itemsize={itemsize},c={c_bytes},python={py_bytes}")
            if c_bytes != py_bytes or py_bytes > kw.MAX_SMEM:
                fail(f"wkv6_batched shared memory: C {c_bytes} B, Python "
                     f"{py_bytes} B (limit {kw.MAX_SMEM})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "an NVIDIA GPU")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from a "
             f"checkout of the repository")
    sys.path.insert(0, src)
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kf
    t_phase = time.perf_counter()

    def phase_done(n: int) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        print(f"phase,{n},seconds={now - t_phase:.1f}", flush=True)
        t_phase = now

    # phase 1: the card, then the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"gpu: {smi.stdout.strip()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    _build.library(rebuild=True)
    print(f"build: {_build.build_seconds:.2f} s for "
          f"{len(_build.sources())} sources")
    for line in _build.build_log.splitlines():
        if "registers" in line or line.startswith("---"):
            print(f"ptxas: {line.strip()}")
    # the redesigned kernels' registers, shared memory and spills
    wgmma_instances = 0
    for src, name, regs, spills in ptxas_entries(_build.build_log):
        if "wgmma" in name or src in ("flash_decode.cu", "wkv6.cu",
                                      "mandelbrot.cu", "spin_image.cu",
                                      "moe.cu"):
            print(f"ptxas,{src},{name},{regs},{spills}")
        # the grouped expert product keeps its accumulators and A
        # fragments in registers
        if "moe_gemm_kernel" in name and spill_bytes(spills):
            fail(f"ptxas spills in {name}: {spills}")
        # every (D, Dv) instance of the wgmma kernel keeps its O, S and P
        # in registers: a spill would put them in local memory
        if "flash_attention_wgmma" in name:
            wgmma_instances += 1
            if spill_bytes(spills):
                fail(f"ptxas spills in {name}: {spills}")
    check_wkv6_smem(_build)
    sass = sass_counts(_build, "flash_attention_wgmma")
    for name, c in sass.items():
        print(f"sass,{name},HGMMA={c['HGMMA']},UTMALDG={c['UTMALDG']}")
    if (len(sass) != len(kf.WGMMA_DIMS) or wgmma_instances != len(sass)
            or not all(c["HGMMA"] > 0 and c["UTMALDG"] > 0
                       for c in sass.values())):
        fail(f"the built flash_attention wgmma kernel has {len(sass)} "
             f"instances ({wgmma_instances} in the ptxas report) for "
             f"{len(kf.WGMMA_DIMS)} head-dim pairs, or one lacks HGMMA "
             f"or UTMALDG instructions: {sass}")
    # the grouped expert product: 4 instances (two variants x gate-up and
    # down), each on wgmma with its weights through TMA
    moe_sass = sass_counts(_build, "moe_gemm_kernel")
    for name, c in moe_sass.items():
        print(f"sass,{name},HGMMA={c['HGMMA']},UTMALDG={c['UTMALDG']}")
    if len(moe_sass) != 4 or not all(c["HGMMA"] > 0 and c["UTMALDG"] > 0
                                     for c in moe_sass.values()):
        fail(f"the built moe_gemm kernel has {len(moe_sass)} instances "
             f"for 4, or one lacks HGMMA or UTMALDG instructions: "
             f"{moe_sass}")
    dev = torch.device("cuda")

    phase_done(1)
    # phase 2: kernels against their plain versions
    rows = compare_kernels(dev)
    rows.update(compare_decode_kernels(dev))
    rows.update(compare_attention_kernel(dev))
    rows.update(compare_moe_kernels(dev))

    phase_done(2)
    # phase 3: rDLB end to end, with a real fail-stop
    run = drive_main_path(dev)
    mst, pst, launches = run["mst"], run["pst"], run["launches"]
    print(f"rdlb,mandelbrot,tiles={mst.n_finished},"
          f"n_duplicates={mst.n_duplicates},wasted={mst.wasted_tasks},"
          f"survivors={mst.survivors},wall_s={run['t_m']:.4f},"
          f"iterations={int(run['img'].sum())}")
    print(f"rdlb,psia,points={pst.n_finished},"
          f"n_duplicates={pst.n_duplicates},wasted={pst.wasted_tasks},"
          f"survivors={pst.survivors},wall_s={run['t_p']:.4f},"
          f"binned={int(run['spins'].sum())}")
    print(f"launches on the main path: {launches}")
    status = run["status"]
    for site in ("mandelbrot", "spin_image"):
        if launches.get(site, 0) <= 0:
            fail(f"kernel {site} was not launched on the main path")
        if status.get(site, {}).get("path") != "cuda":
            fail(f"dispatch status of {site} is {status.get(site)}")
        rows[site]["launches"] = launches[site]
    check_main_path(dev, run)
    print("rdlb: fail-stop results equal failure-free runs bit for bit")
    for app, site in (("mandelbrot", "mandelbrot"), ("psia", "spin_image")):
        rows[site]["kernel_ms_per_run"] = profile_app_run(
            dev, app)["kernel_ms_per_run"]

    phase_done(3)
    # phase 4: serving, each model's run with its own launch counts
    for arch in SERVE_ARCHS:
        for site, n in drive_serving(dev, arch).items():
            rows[site]["launches"] = n

    phase_done(4)
    # phase 5: training, with its own launch counts
    rows["flash_attention"]["launches"] = drive_training(dev, TRAIN_ARCH)
    check_train_float32(dev, TRAIN_ARCH)
    rows["wkv6_batched"]["launches_training"] = drive_training(
        dev, "rwkv6-1.6b")
    check_train_float32(dev, "rwkv6-1.6b")
    restart_on_the_card()

    phase_done(5)
    # phase 6: the other model families, each run with its own counts
    drive_families(dev, rows)
    phase_done(6)

    # phase 7: the batched simulator and adaptive re-planning
    t0 = time.perf_counter()
    sim = drive_devicesim(dev)
    sim["seconds"] = time.perf_counter() - t0
    sim["gpu"] = smi.stdout.strip()
    phase_done(7)

    # phase 8: process mode, the children's launch counts (each child
    # counts its own; the master's say nothing about them)
    for site, n in drive_process(dev, run["img"], run["spins"]).items():
        rows[site]["launches_process"] = n
    phase_done(8)

    # phase 9: the serving executor's other paths, each run with its own
    # launch counts
    drive_executor(dev, rows)
    phase_done(9)

    # phase 10: report
    print(json.dumps({"devicesim": sim}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
