#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal when it fails:

  1. print the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/csrc`` and print the build time and ptxas report;
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes of the main path (exact equality: both round every
     operation the same way), and time both: the kernel as a CUDA graph
     of launches (``ms``), in a profiler trace (``trace_ms``) and per
     back-to-back call (``call_ms``);
  3. drive the main path through the public API: threaded rDLB
     self-scheduling of the paper's Mandelbrot (512 x 512, 256
     iterations, SS, P=4) and PSIA (20,000 spin images over 16,384
     points, FAC, P=4), each with one worker that fail-stops.  Launch
     counts are set to 0 just before and read just after; every kernel
     must have launched.  The results must equal failure-free runs bit
     for bit, and a few tiles and spin images must equal the plain
     version computed on the CPU;
  4. print one JSON line with each kernel's launches, error, times and
     bound, then the result line.

Exits non-zero, printing no result, when no GPU is present or when the
script is run outside a checkout of the repository.
"""

from __future__ import annotations

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
    for site in rows:
        if launches.get(site, 0) <= 0:
            fail(f"kernel {site} was not launched on the main path")
    check_main_path(dev, run)
    print("rdlb: fail-stop results equal failure-free runs bit for bit")

    # phase 4: report
    status = run["status"]
    for site in rows:
        if status.get(site, {}).get("path") != "cuda":
            fail(f"dispatch status of {site} is {status.get(site)}")
        rows[site]["launches"] = launches[site]
        rows[site]["path"] = status[site]["path"]
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
