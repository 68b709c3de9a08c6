"""Robust serving from the command line: batched requests through the rDLB serve executor.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
        --smoke --requests 8 --n-workers 4 --fail-worker 1 [--device cpu]

Weights come from the port's own seeded init (``--seed``).  The replicas
run as threads on the card unless ``--device cpu`` is given.  Greedy
decode is deterministic, so rDLB request duplication is safe: a
straggling/failed replica's in-flight requests are re-decoded by idle
replicas and the first completion wins.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import api
from repro_torch.configs import get_config, get_smoke
from repro_torch.device import resolve
from repro_torch.models import build_model
from repro_torch.runtime import RDLBServeExecutor, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=4)
    ap.add_argument("--n-workers", type=int, default=4)
    ap.add_argument("--technique", default="SS")
    ap.add_argument("--no-rdlb", action="store_true")
    ap.add_argument("--fail-worker", type=int, default=-1,
                    help="worker id to fail after its first request")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    params = model.init(args.seed, device=dev)
    spec = api.serve_spec(technique=args.technique,
                          n_workers=args.n_workers,
                          rdlb_enabled=not args.no_rdlb, threaded=True)
    ex = RDLBServeExecutor(model, params, spec=spec)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    size=args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new_tokens)
            for i in range(args.requests)]
    fail_at = ({args.fail_worker: 1} if args.fail_worker >= 0 else None)
    t0 = time.time()
    stats = ex.serve(reqs, fail_at=fail_at)
    dt = time.time() - t0
    n_done = sum(1 for r in reqs if r.output is not None)
    print(f"served {n_done}/{stats.n_requests} requests in {dt:.2f}s on "
          f"{dev} ({stats.n_duplicates} duplicates, {stats.wasted_requests}"
          f" wasted, hung={stats.hung}) by_worker={stats.by_worker}")
    if stats.hung:
        raise SystemExit("serve hung (non-robust scheduling + failure)")
    for r in reqs[:4]:
        print(f"  req {r.rid}: worker {r.completed_by} "
              f"dup={r.duplicated} -> {r.output.tolist()}")
    return stats


if __name__ == "__main__":
    main()
