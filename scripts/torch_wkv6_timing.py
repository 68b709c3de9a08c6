#!/usr/bin/env python3
"""Time the port's two RWKV6 kernels, and one rwkv6-1.6b prefill, on one
GPU: the wkv6 part of ``chip_smoke.py``'s phase 2 (each kernel against
its plain version, then timed beside its bound at BH = 32 and 256, and
the batched kernel at T = 37, 64 and 1000) and phase 4's prefill of one
1000-token prompt at full width.

    python3 scripts/torch_wkv6_timing.py [--src DIR] [--label NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two versions of the kernels can be
compared on one card in turns, each in its own process; that tree's
``rwkv6_scan`` must have the column split (``col_split``).  The last line
is one JSON object with the timed shapes and the prefill's wall seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_wkv6_timing: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"gpu: {smi.stdout.strip()}")
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    _build.library(rebuild=True)
    for src, name, regs, spills in chip_smoke.ptxas_entries(
            _build.build_log):
        if src == "wkv6.cu":
            print(f"ptxas,{src},{name},{regs},{spills}")
    dev = torch.device("cuda")
    rows = chip_smoke.compare_wkv6_kernels(dev)
    model = build_model(get_config(chip_smoke.PREFILL_ARCH))
    params = model.init(0, device=dev)
    walls = chip_smoke.time_prefill(model, params)
    print(f"prefill,{chip_smoke.PREFILL_ARCH},B=1,T={chip_smoke.PREFILL_T}"
          f": wall_s={walls}")
    print(json.dumps({"label": args.label, "src": args.src,
                      "gpu": torch.cuda.get_device_name(0),
                      "shapes": [dict(kernel=name, **t)
                                 for name, r in rows.items()
                                 for t in r["shapes"]],
                      "prefill_wall_s": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
