#!/usr/bin/env python3
"""Where spin_image's time goes at the PSIA run's large chunks: the kernel
of ``src/repro_torch/csrc/spin_image.cu`` against variants that each
change one thing, on one GPU.

    python3 scripts/torch_spin_image_ablation.py [--rounds 2]

Each variant is the committed source with the text patches listed in
``VARIANTS`` applied (each patch must match exactly, so a change to the
kernel that a patch no longer fits stops the script).  Every variant is
built with nvcc on its own (all started together) into
``build/ablation/<name>/``, called through its C entry with the
wrapper's arguments (``pt_split``'s split, times ``split_x``), held against
``spin_image_plain`` (differing bins counted: the variants marked
inexact drop work on purpose and are for timing only), and timed as a
CUDA graph of launches between CUDA events at 2,500, 1,250, 625 and 313
centers over the paper's 16,384-point cloud, the chunks of the PSIA run
that carry most of its kernel time.  Variants are timed in turns,
``--rounds`` times.  The card's name and power limit come first, then
each variant's ptxas line; the last line is one JSON object with every
number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys
from typing import NamedTuple

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "ablation"
CENTERS = (2500, 1250, 625, 313)

# The cloud read from L1: every thread re-reads the first 1,024 points.
L1_CLOUD = [("      const float4 a = quads[3 * q], d = quads[3 * q + 1],\n"
             "                   e = quads[3 * q + 2];",
             "      const int r = q & 255;\n"
             "      const float4 a = quads[3 * r], d = quads[3 * r + 1],\n"
             "                   e = quads[3 * r + 2];")]
# The bin computed and discarded: no shared-memory add.
NO_ATOMIC = [("  if (idx >= 0) atomicAdd(&hist[idx], 1);",
              "  asm volatile(\"\" ::\"r\"(idx));")]


def group_patches(g: int) -> list:
    """A CTA bins each point it loads for ``g`` consecutive centers, one
    histogram each (g x 16 KB of shared memory), so the cloud is streamed
    once per g centers; exact."""
    return [
        ("constexpr int kThreads = 256;",
         f"constexpr int kThreads = 256;\nconstexpr int kG = {g};"),
        ("float* __restrict__ out, Bins s, int split) {",
         "float* __restrict__ out, Bins s, int split,\n"
         "                      int n_centers) {"),
        ("  const int b = blockIdx.x / split;          // the center",
         "  const int b = blockIdx.x / split * kG;\n"
         "  const int n_here = min(kG, n_centers - b);"),
        ("  for (int i = threadIdx.x; i < n_bins; i += kThreads) hist[i] = 0;",
         "  for (int i = threadIdx.x; i < kG * n_bins; i += kThreads)\n"
         "    hist[i] = 0;"),
        ("  float c[3], nrm[3];\n"
         "  for (int k = 0; k < 3; ++k) {\n"
         "    c[k] = centers[3 * b + k];\n"
         "    nrm[k] = normals[3 * b + k];\n"
         "  }",
         "  float c[kG][3], nrm[kG][3];\n"
         "#pragma unroll\n"
         "  for (int g = 0; g < kG; ++g) {\n"
         "    const int bg = min(b + g, n_centers - 1);\n"
         "#pragma unroll\n"
         "    for (int k = 0; k < 3; ++k) {\n"
         "      c[g][k] = centers[3 * bg + k];\n"
         "      nrm[g][k] = normals[3 * bg + k];\n"
         "    }\n"
         "  }"),
        (re.compile(r"add\(hist, bin_of\(([^;]*?),\s*c,\s*nrm, s\)\);", re.S),
         r'_Pragma("unroll") for (int g = 0; g < kG; ++g)'
         r" add(hist + g * n_bins, bin_of(\1, c[g], nrm[g], s));", 5),
        ("  float* dst = out + static_cast<long long>(b) * n_bins;",
         "  float* dst = out + static_cast<long long>(b) * n_bins;\n"
         "  const int n_out = n_here * n_bins;"),
        ("    for (int i = threadIdx.x; i < n_bins; i += kThreads)\n"
         "      dst[i] = static_cast<float>(hist[i]);",
         "    for (int i = threadIdx.x; i < n_out; i += kThreads)\n"
         "      dst[i] = static_cast<float>(hist[i]);"),
        ("  const int share = (n_bins + split - 1) / split;\n"
         "  const int i1 = min(n_bins, (rank + 1) * share);",
         "  const int share = (n_out + split - 1) / split;\n"
         "  const int i1 = min(n_out, (rank + 1) * share);"),
        ("  const size_t smem = sizeof(int) * static_cast<size_t>(s.n_alpha)"
         " * s.n_beta;",
         "  const size_t smem =\n"
         "      kG * sizeof(int) * static_cast<size_t>(s.n_alpha) * s.n_beta;"),
        ("  cfg.gridDim = dim3(static_cast<unsigned>(n_centers) * split);",
         "  cfg.gridDim =\n"
         "      dim3(static_cast<unsigned>((n_centers + kG - 1) / kG) * split);"),
        ("centers, normals, out, s, split);",
         "centers, normals, out, s, split,\n"
         "                                             n_centers);"),
    ]


class Variant(NamedTuple):
    what: str                   # what it changes
    exact: bool                 # whether it must equal the plain version
    patches: list               # (old, new[, matches]) text patches
    split_x: int = 1            # times pt_split's CTAs a center


VARIANTS = {
    "committed": Variant("the kernel as committed", True, []),
    "exact_only": Variant(
        "every pair through the correctly rounded chain (__fsqrt_rn, "
        "__fdiv_rn), no fast binning", True,
        [("  return bin == floor_magic(x, 1.f + kEps);",
          "  return false;")]),
    "fast_only": Variant(
        "the fast binning without its guard: no correctly rounded chain, "
        "no second floor", False,
        [("  return bin == floor_magic(x, 1.f + kEps);", "  return true;")]),
    "no_contention": Variant(
        "each thread's atomic add into its own slot: the same adds, no two "
        "threads on one address", False,
        [("  if (idx >= 0) atomicAdd(&hist[idx], 1);",
          "  if (idx >= 0) atomicAdd(&hist[threadIdx.x], 1);")]),
    "warp_aggregated": Variant(
        "the lanes of a warp with one bin add once, their count "
        "(__match_any_sync)", True,
        [("  if (idx >= 0) atomicAdd(&hist[idx], 1);",
          "  const unsigned peers = __match_any_sync(__activemask(), idx);\n"
          "  if (idx >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)\n"
          "    atomicAdd(&hist[idx], __popc(peers));")]),
    "no_atomic": Variant("the bin computed and discarded: no add", False,
                         NO_ATOMIC),
    "l1_cloud": Variant(
        "the cloud read from L1: each thread re-reads the first 1,024 "
        "points, so nothing streams from L2", False, L1_CLOUD),
    "arith_only": Variant("l1_cloud and no_atomic: the binning arithmetic "
                          "alone", False, L1_CLOUD + NO_ATOMIC),
    "loads_only": Variant(
        "the cloud streamed as committed, each point's three coordinates "
        "xor-ed into a discarded value: no arithmetic, no add", False,
        NO_ATOMIC + [("  const float dx = __fsub_rn(px, c[0]);",
                      "  if (s.n_alpha > 0)\n"
                      "    return __float_as_int(px) ^ __float_as_int(py) ^ "
                      "__float_as_int(pz);\n"
                      "  const float dx = __fsub_rn(px, c[0]);")]),
    "element_loads": Variant(
        "the cloud read as three 4-byte loads a point, as for a cloud off "
        "16-byte alignment, not three float4 a 4 points", True,
        [("  if (reinterpret_cast<uintptr_t>(points) % 16 == 0)",
          "  if (false)")]),
    "split2": Variant("the kernel as committed over twice pt_split's CTAs "
                      "a center (a cluster of 2)", True, [], split_x=2),
    "group2": Variant(
        "two centers a CTA: each loaded point binned for both, the cloud "
        "streamed once per two centers", True, group_patches(2)),
    "group4": Variant("four centers a CTA, likewise", True,
                      group_patches(4)),
}


def patched(src: str, patches: list) -> str:
    for p in patches:
        old, new = p[0], p[1]
        want = p[2] if len(p) > 2 else 1
        if isinstance(old, re.Pattern):
            src, n = old.subn(new, src)
        else:
            n = src.count(old)
            src = src.replace(old, new)
        if n != want:
            raise SystemExit(f"a patch matched {n} times, not {want}: "
                             f"{getattr(old, 'pattern', old)[:60]!r}")
    return src


def build(names: list, nvcc: str, flags: list) -> dict:
    """Each variant's shared library, built in parallel -> name: (path,
    ptxas 'Used' line)."""
    base = (CSRC / "spin_image.cu").read_text()
    procs = {}
    for name in names:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "spin_image.cu").write_text(patched(base,
                                                 VARIANTS[name].patches))
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-shared", "-I", str(CSRC),
             str(d / "spin_image.cu"), "-o", str(d / "libspin.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log}")
        used = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                if "Used" in ln]
        libs[name] = (OUT / name / "libspin.so", "; ".join(used))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_spin_image_ablation: needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"gpu: {smi.stdout.strip()}")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.apps import psia
    from repro_torch.kernels import _build
    from repro_torch.kernels import spin_image as ks
    libs = build(list(VARIANTS), _build.nvcc(), [*_build.ARCH, *_build.FLAGS])
    dev = torch.device("cuda")
    data = psia.dataset(n=psia.PAPER_N, cloud_n=psia.CLOUD, device=dev)
    pts = data.points
    kw = dict(n_alpha=psia.N_ALPHA, n_beta=psia.N_BETA,
              alpha_max=psia.ALPHA_MAX, beta_max=psia.BETA_MAX)
    fns = {}
    for name, (path, used) in libs.items():
        fn = ctypes.CDLL(str(path)).spin_image_launch
        fn.argtypes, fn.restype = ks._ARGTYPES, ctypes.c_int
        fns[name] = fn
        print(f"ptxas,{name},{used}")

    def launch(name, n, out):
        split = ks.pt_split(n, pts.shape[0]) * VARIANTS[name].split_x
        _build.check(fns[name](pts.data_ptr(), pts.shape[0],
                               data.centers.data_ptr(),
                               data.normals.data_ptr(), out.data_ptr(), n,
                               kw["n_alpha"], kw["n_beta"], kw["alpha_max"],
                               kw["beta_max"], split,
                               torch.cuda.current_stream().cuda_stream),
                     f"spin_image variant {name}")

    n = max(CENTERS)
    want = ks.spin_image_plain(pts, data.centers[:n], data.normals[:n], **kw)
    report = {}
    for name in fns:
        out = torch.empty_like(want)
        launch(name, n, out)
        bad = int((out != want).sum())
        what, exact = VARIANTS[name].what, VARIANTS[name].exact
        if exact and bad:
            cs.fail(f"variant {name} is meant to be exact and differs in "
                    f"{bad} bins")
        report[name] = dict(what=what, exact=exact, differing_bins=bad,
                            ptxas=libs[name][1],
                            ms={str(c): [] for c in CENTERS})
        print(f"check,{name},exact={exact},differing_bins={bad}")
    for r in range(args.rounds):
        for name in fns:
            for c in CENTERS:
                out = torch.empty((c, kw["n_beta"], kw["n_alpha"]),
                                  device=dev)
                ms = cs.graph_ms(lambda name=name, c=c, out=out:
                                 launch(name, c, out), 20)
                report[name]["ms"][str(c)].append(ms)
            print(f"ablation,round={r},{name},"
                  + ",".join(f"{c}={report[name]['ms'][str(c)][-1]:.6f}"
                             for c in CENTERS))
    print(json.dumps({"gpu": smi.stdout.strip(), "centers": CENTERS,
                      "points": pts.shape[0], "variants": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
