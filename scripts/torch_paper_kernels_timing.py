#!/usr/bin/env python3
"""Time the paper path's two kernels, mandelbrot and spin_image, on one
GPU at the shapes the rDLB runs of ``chip_smoke.py``'s phase 3 launch,
and profile one failure-free run of each app.

    python3 scripts/torch_paper_kernels_timing.py [--src DIR] [--label NAME]

This is the paper-kernel part of ``chip_smoke.py``'s phases 2 and 3.
Each kernel is first held against its plain version (exactly) at every
shape, then timed beside its bound (the larger of bytes over 3.35 TB/s
and FP32 operations over 67 TFLOP/s):

* mandelbrot at the whole 512 x 512 image, at each of its 64 tiles of
  64 x 64 alone (the shape of one rDLB task; tile 29 is the deepest,
  tile 0 the lightest), and the 64 tiles launched in turn.  Beside each
  tile stands its dependent-chain floor: the deepest pixel's escape
  count times ``CHAIN_CYCLES`` over the SM clock that ``nvidia-smi``
  reports as the card's maximum.  It is a floor of this arithmetic, not
  a bound of the work.  Each tile is a strided view of the grid, as
  ``compute_tile`` launches it;
* spin_image at every distinct chunk size that FAC gives the PSIA run
  (N = 20,000 tasks, P = 4 workers, from ``repro_torch.core.dls``) and
  at 2,048 centers, over the 16,384-point cloud (compared also on a
  cloud a point short, one off 16-byte alignment and points on bin
  edges).  The guard's share is left to ``chip_smoke.py``.

Then one failure-free rDLB run of each app, as phase 3 drives it, is
traced with ``torch.profiler``: each app kernel's device ms summed over
the run (kernel ms per run), its calls, and all device time, copies
included.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two versions can be compared on one
card in turns, each in its own process; this checkout's ``chip_smoke.py``
drives both, so the other tree needs the wrappers' current interface
(strided tiles, ``pt_split``, ``bin_edge_cloud``).  Time a tree from
before that with its own ``chip_smoke.py``.  The card's name and power limit come first; the last line
is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_paper_kernels_timing: needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"gpu: {smi.stdout.strip()}")
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import _build
    _build.library(rebuild=True)
    for src, name, regs, spills in cs.ptxas_entries(_build.build_log):
        if src in ("mandelbrot.cu", "spin_image.cu"):
            print(f"ptxas,{src},{name},{regs},{spills}")
    dev = torch.device("cuda")
    mandel = cs.compare_mandelbrot(dev, every_tile=True)
    spin = cs.compare_spin_image(dev)
    runs = [cs.profile_app_run(dev, app) for app in ("mandelbrot", "psia")]
    print(json.dumps({"label": args.label, "src": args.src,
                      "gpu": smi.stdout.strip(),
                      "sm_clock_max_mhz": cs.sm_clock_mhz(),
                      "mandelbrot": {k: mandel[k] for k in
                                     ("shape", "ms", "bound_ms", "shapes")},
                      "spin_image": spin["shapes"], "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
