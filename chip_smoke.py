#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal when it fails:

  1. print the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/csrc`` and print the build time and ptxas report;
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes of the main paths, with the tolerance printed, and time
     both: the kernel as a CUDA graph of launches (``ms``), in a profiler
     trace (``trace_ms``) and per back-to-back call (``call_ms``), and,
     where one PyTorch call computes the same function, that call
     (``library_ms``).  mandelbrot and spin_image agree exactly;
     flash_decode (olmo-1b's 8 x 16 rows of 128 at L = 1016 and 1024,
     float32 and bfloat16, scattered and fully masked blocks),
     wkv6_decode and wkv6_batched (rwkv6-1.6b's 8 x 32 heads of 64,
     T = 64 and a ragged 37) within float32 rounding;
  3. drive the paper's main path through the public API: threaded rDLB
     self-scheduling of the paper's Mandelbrot (512 x 512, 256
     iterations, SS, P=4) and PSIA (20,000 spin images over 16,384
     points, FAC, P=4), each with one worker that fail-stops.  Launch
     counts are set to 0 just before and read just after; every kernel
     must have launched.  The results must equal failure-free runs bit
     for bit, and a few tiles and spin images must equal the plain
     version computed on the CPU;
  4. drive the serving path for olmo-1b and rwkv6-1.6b at full width in
     bfloat16 with seeded random weights: threaded rDLB (SS, P=4) over
     16 requests of prompt lengths 37, 64 and 1000, 16 new tokens each,
     worker 1 fail-stopping after 2 requests.  Launch counts are set to 0
     just before each run and read just after: flash_decode must have
     launched in olmo-1b's, wkv6_decode and wkv6_batched in
     rwkv6-1.6b's.  Every request's tokens must equal a failure-free
     run's bit for bit, with at least one rDLB duplicate.  A float32 copy
     of each config cut to 2 layers (full width) must give the same
     greedy tokens through the kernels as through their plain versions,
     both on the card.  Then decode throughput: FusedGenerator at B = 8,
     S = 64, 64 new tokens, and one profiled call of 8 new tokens for the
     kernels per token position, the device's busy share and the ops
     that take the most host time;
  5. print one JSON line with each kernel's launches, error, times and
     bound, then the result line.

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
PEAK_BYTES = 3.35e12
# FP32 operations per Mandelbrot iteration (3 mul, 3 add/sub, 1 compare,
# 1 FMA counted as 2) and per spin-image point-center pair (3 sub,
# 6 mul + 4 add for beta and r2, beta^2, sub, max, sqrt, 2 div, 2 mul,
# 1 add, 2 floor, plus the 4 range compares left uncounted).
OPS_PER_ITER = 9
OPS_PER_PAIR = 24

# The image, iteration cap, PSIA points and cloud are the paper's
# (Table 1), read from the apps' own constants.  A Mandelbrot task is one
# TILE x TILE tile; SPIN_CHUNK centers are compared and timed, about the
# first FAC chunk at P=4.
TILE = 64
SPIN_CHUNK = 2048

# Serving (phase 4): olmo-1b carries flash_decode, rwkv6-1.6b the two
# wkv6 kernels.  Prompt lengths cycle over SERVE_PROMPTS.
SERVE_ARCHS = ("olmo-1b", "rwkv6-1.6b")
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
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            return us / ev.count / 1e3 if us else None
    return None


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ phase 2
def compare_kernels(dev) -> dict:
    """Each kernel against its plain version on ``dev``, at the main
    path's shapes, and timed; returns the per-kernel report rows."""
    from repro_torch.apps import mandelbrot, psia
    from repro_torch.kernels import mandelbrot as km, spin_image as ks

    rows = {}
    side, max_iters = mandelbrot.SIDE, mandelbrot.MAX_ITERS
    cr, ci = mandelbrot.grid(side, device=dev)
    got = km.mandelbrot(cr, ci, max_iters=max_iters)
    want = km.mandelbrot_plain(cr, ci, max_iters)
    n_diff = int((got != want).sum())
    err = float((got - want).abs().max())
    # and one tile, the shape each rDLB task gives the kernel
    tcr = cr[:TILE, :TILE].contiguous()
    tci = ci[:TILE, :TILE].contiguous()
    n_diff += int((km.mandelbrot(tcr, tci, max_iters=max_iters)
                   != km.mandelbrot_plain(tcr, tci, max_iters)).sum())
    print(f"compare,mandelbrot,{side}x{side} and {TILE}x{TILE}"
          f"/{max_iters},differing_pixels={n_diff},max_abs_err={err}")
    if n_diff:
        fail(f"mandelbrot kernel differs from its plain version in "
             f"{n_diff} pixels")
    iters = int(want.sum())
    b, by = bound_ms(3 * side * side * 4, OPS_PER_ITER * iters)
    rows["mandelbrot"] = dict(
        name="mandelbrot", route="cuda",
        source="src/repro_torch/csrc/mandelbrot.cu",
        replaces="src/repro/kernels/mandelbrot.py:49",
        shape=f"({side},{side}) max_iters={max_iters}",
        iterations=iters, max_abs_err=err, bound_ms=b, bound_by=by,
        library_ms=None)
    launch = lambda: km.mandelbrot(cr, ci, max_iters=max_iters)  # noqa: E731
    rows["mandelbrot"].update(
        ms=graph_ms(launch, 200),
        trace_ms=trace_ms(launch, "mandelbrot_kernel", 200),
        call_ms=call_ms(launch, 200),
        plain_ms=call_ms(lambda: km.mandelbrot_plain(cr, ci, max_iters),
                         3, warmup=1))

    data = psia.dataset(n=psia.PAPER_N, cloud_n=psia.CLOUD, device=dev)
    pts = data.points
    ctr = data.centers[:SPIN_CHUNK].contiguous()
    nrm = data.normals[:SPIN_CHUNK].contiguous()
    kw = dict(n_alpha=psia.N_ALPHA, n_beta=psia.N_BETA,
              alpha_max=psia.ALPHA_MAX, beta_max=psia.BETA_MAX)
    got = ks.spin_image(pts, ctr, nrm, **kw)
    want = ks.spin_image_plain(pts, ctr, nrm, **kw)
    n_diff = int((got != want).sum())
    err = float((got - want).abs().max())
    print(f"compare,spin_image,{ctr.shape[0]}x{pts.shape[0]}x"
          f"{psia.N_BETA}x{psia.N_ALPHA},differing_bins={n_diff},"
          f"max_abs_err={err},binned={int(want.sum())}")
    if n_diff:
        fail(f"spin_image kernel differs from its plain version in "
             f"{n_diff} bins")
    n_bytes = (pts.numel() + ctr.numel() + nrm.numel() + got.numel()) * 4
    b, by = bound_ms(n_bytes, OPS_PER_PAIR * ctr.shape[0] * pts.shape[0])
    rows["spin_image"] = dict(
        name="spin_image", route="cuda",
        source="src/repro_torch/csrc/spin_image.cu",
        replaces="src/repro/kernels/spin_image.py:71",
        shape=f"centers={ctr.shape[0]} points={pts.shape[0]} "
              f"bins={psia.N_BETA}x{psia.N_ALPHA}",
        max_abs_err=err, bound_ms=b, bound_by=by, library_ms=None)
    launch = lambda: ks.spin_image(pts, ctr, nrm, **kw)  # noqa: E731
    rows["spin_image"].update(
        ms=graph_ms(launch, 50),
        trace_ms=trace_ms(launch, "spin_image_kernel", 50),
        call_ms=call_ms(launch, 50),
        plain_ms=call_ms(lambda: ks.spin_image_plain(pts, ctr, nrm, **kw),
                         3, warmup=1))
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
    for L in (1016, 1024):
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
                f"valid={int(valid.sum())}", dtype,
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

    # wkv6: rwkv6-1.6b's heads at B = 8
    dk = rwkv.rwkv_head_dim
    BH = B * rwkv.d_model // dk

    def wkv_inputs(T, dtype):
        lead = (BH, T) if T else (BH,)
        r, k, v = (torch.randn(lead + (dk,), generator=gen)
                   for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn(lead + (dk,), generator=gen)
                                 * 0.5 - 1.0))
        u = torch.randn((BH, dk), generator=gen)
        s = torch.randn((BH, dk, dk), generator=gen)
        return [x.to(dev, dtype) for x in (r, k, v, w, u)] + [s.to(dev)]

    def rel_err(got, want):
        return float((got - want).abs().max() / want.abs().max())

    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        ins = wkv_inputs(0, dtype)
        y, s = kw.wkv6_decode(*ins)
        py, ps = kw.wkv6_decode_plain(*ins)
        e = max(rel_err(y, py), rel_err(s, ps))
        print(f"compare,wkv6_decode,BH={BH},{dk}x{dk},{dtype},"
              f"max_rel_err={e},tolerance=1e-05")
        if not e <= 1e-5:
            fail(f"wkv6_decode differs from its plain version by {e}")
        err = max(err, float((y - py).abs().max()),
                  float((s - ps).abs().max()))
    ins = wkv_inputs(0, torch.bfloat16)
    state = ins[5].clone()
    n_bytes = 2 * 5 * BH * dk + 4 * (2 * BH * dk * dk + BH * dk)
    b, by = bound_ms(n_bytes, 7 * BH * dk * dk)
    _report(rows, "wkv6_decode", source="src/repro_torch/csrc/wkv6.cu",
            replaces="src/repro/kernels/rwkv6_scan.py:124",
            shape=f"BH={BH} {dk}x{dk}, bf16 inputs, state in place",
            max_abs_err=err, bound_ms=b, bound_by=by)
    _time(rows, "wkv6_decode",
          lambda: kw.wkv6_decode(*ins[:5], state, out_state=state),
          lambda: kw.wkv6_decode_plain(*ins), "wkv6_decode_kernel", 200)

    err = 0.0
    for T in (64, 37):
        ins = wkv_inputs(T, torch.bfloat16)
        y, s = kw.wkv6_batched(*ins)
        py, ps = kw.wkv6_batched_plain(*ins)
        e = max(rel_err(y, py), rel_err(s, ps))
        print(f"compare,wkv6_batched,BH={BH},T={T},{dk}x{dk},bf16,"
              f"chunk={kw.CHUNK},max_rel_err={e},tolerance=1e-04")
        if not e <= 1e-4:
            fail(f"wkv6_batched differs from its plain version by {e}")
        err = max(err, float((y - py).abs().max()),
                  float((s - ps).abs().max()))
    T = 64
    ins = wkv_inputs(T, torch.bfloat16)
    n_bytes = (2 * (4 * BH * T * dk + BH * dk) + 4 * BH * T * dk
               + 8 * BH * dk * dk)
    b, by = bound_ms(n_bytes, wkv6_batched_ops(BH, T, dk, dk, kw.CHUNK))
    _report(rows, "wkv6_batched", source="src/repro_torch/csrc/wkv6.cu",
            replaces="src/repro/kernels/rwkv6_scan.py:69",
            shape=f"BH={BH} T={T} {dk}x{dk}, bf16 inputs, chunk "
                  f"{kw.CHUNK}", max_abs_err=err, bound_ms=b, bound_by=by)
    _time(rows, "wkv6_batched", lambda: kw.wkv6_batched(*ins),
          lambda: kw.wkv6_batched_plain(*ins), "wkv6_batched_kernel", 100)
    return rows


# ------------------------------------------------------------ phase 4
def serve_requests(vocab: int):
    import numpy as np
    from repro_torch.runtime import Request
    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(
        0, vocab, size=SERVE_PROMPTS[i % len(SERVE_PROMPTS)]).astype(
            np.int32), max_new_tokens=SERVE_NEW)
        for i in range(SERVE_REQUESTS)]


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

    def with_out(plain):
        def fn(*args, out_state=None, **kwargs):
            y, s = plain(*args, **kwargs)
            return y, (s if out_state is None else out_state.copy_(s))
        return fn

    swap = {"flash_decode_gqa": kf.flash_decode_gqa_plain,
            "wkv6_decode": with_out(kw.wkv6_decode_plain),
            "wkv6_batched": with_out(kw.wkv6_batched_plain)}
    saved = {name: getattr(ops, name) for name in swap}
    before = dispatch.launches()
    for name, fn in swap.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
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
    events = prof.key_averages()
    kernels = [e for e in events if e.count and
               str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(getattr(e, "self_device_time_total", 0)
                  or getattr(e, "self_cuda_time_total", 0) for e in kernels)
    host = sorted(events, key=lambda e: e.self_cpu_time_total,
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


SERVE_SITES = {"olmo-1b": ("flash_decode",),
               "rwkv6-1.6b": ("wkv6_decode", "wkv6_batched")}


def drive_serving(dev, arch: str) -> dict:
    """Phase 4 for one arch; returns the kernel launches of its fail-stop
    run and prints its numbers."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models import build_model
    cfg = get_config(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"serve,{arch},params={n_params},{cfg.dtype},"
          f"init_s={time.perf_counter() - t0:.3f}")
    dispatch.reset_launches()
    reqs, st, wall = run_serving(model, params, failing=True)
    launches = dispatch.launches()
    status = dispatch.status()
    print(f"rdlb,serve,{arch},requests={len(reqs)},"
          f"n_duplicates={st.n_duplicates},wasted={st.wasted_requests},"
          f"by_worker={st.by_worker},wall_s={wall:.4f},"
          f"tokens={len(reqs) * SERVE_NEW}")
    print(f"launches on the {arch} serving path: {launches}")
    for site in SERVE_SITES[arch]:
        if launches.get(site, 0) <= 0:
            fail(f"kernel {site} was not launched on the {arch} "
                 f"serving path")
        if status.get(site, {}).get("path") != "cuda":
            fail(f"dispatch status of {site} is {status.get(site)}")
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
    tp = decode_throughput(model, params)
    print(f"decode,{arch},B={tp['B']},S={tp['S']},new={tp['new']},"
          f"wall_s={tp['wall_s']:.4f},prefill_s={tp['prefill_s']:.4f},"
          f"tok_s={tp['tok_s']:.1f},ms_per_step={tp['ms_per_step']:.3f}")
    print(f"decode,{arch},profiled new={PROFILED_NEW}: kernels per token "
          f"position={tp['kernels_per_position']:.1f},device busy share="
          f"{tp['busy_share']:.3f},top host ops (name, calls, self ms)="
          f"{tp['top_host_ops']}")
    del model, params
    torch.cuda.empty_cache()
    same = check_plain_tokens(dev, arch)
    print(f"check,{arch},float32 2 layers: kernel tokens equal plain "
          f"tokens {same}")
    return {site: launches[site] for site in SERVE_SITES[arch]}


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
    dev = torch.device("cuda")

    # phase 2: kernels against their plain versions
    rows = compare_kernels(dev)
    rows.update(compare_decode_kernels(dev))

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

    # phase 4: serving, each model's run with its own launch counts
    for arch in SERVE_ARCHS:
        for site, n in drive_serving(dev, arch).items():
            rows[site]["launches"] = n

    # phase 5: report
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
