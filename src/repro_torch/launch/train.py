"""Robust training from the command line: the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --smoke --steps 5 --n-workers 4 --n-tasks 8 --technique FAC \
        --fail "2:1" [--device cpu]

Wires together: config -> model (weights from the port's seeded init,
``--seed``) -> synthetic data -> rDLB executor -> elastic shrink after
failures.  The workers run as threads on the card unless ``--device cpu``
is given; without ``--smoke`` the config is the full-width one, in its
own dtype (bfloat16).

``--fail "STEP:W1,W2"`` kills workers W1,W2 (fail-stop) during STEP —
training continues (rDLB) and the next step runs on the survivors.
``--no-rdlb`` reproduces the paper's hang.  The reference then restarts
from its last checkpoint; checkpoints are not ported yet (``--ckpt-dir``
and ``--ckpt-interval`` raise, ROADMAP.md queue A, item A7), so the hung
run aborts with the reference's message.
"""

from __future__ import annotations

import argparse
import time

from repro_torch import api
from repro_torch.configs import get_config, get_smoke
from repro_torch.data import batch_for_step
from repro_torch.device import resolve
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.runtime import RDLBTrainExecutor
from repro_torch.runtime.elastic import shrink_to_survivors


def parse_fail(spec):
    """"20:1,2" -> {20: [1, 2]}"""
    out = {}
    if spec:
        for part in spec.split(";"):
            step, wids = part.split(":")
            out[int(step)] = [int(w) for w in wids.split(",")]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--n-workers", type=int, default=4)
    ap.add_argument("--n-tasks", type=int, default=8)
    ap.add_argument("--technique", default="FAC")
    ap.add_argument("--no-rdlb", action="store_true")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--fail", default="",
                    help='fault plan, e.g. "20:1,2;40:3"')
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-interval", type=int, default=None,
                    help="not ported: checkpoints are A7 (raises)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    if args.ckpt_dir or args.ckpt_interval is not None:
        raise NotImplementedError(
            "checkpoints (repro.checkpoint) are not ported to repro_torch "
            "yet: ROADMAP.md queue A, item A7")
    dev = resolve(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    spec = api.train_spec(technique=args.technique,
                          n_workers=args.n_workers, n_tasks=args.n_tasks,
                          rdlb_enabled=not args.no_rdlb, threaded=True)
    executor = RDLBTrainExecutor(model, spec=spec,
                                 optimizer=args.optimizer, lr=args.lr)
    params = model.init(args.seed, device=dev)
    opt_state = executor.opt.init(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"workers={args.n_workers} tasks={args.n_tasks} "
          f"technique={args.technique} rdlb={not args.no_rdlb} "
          f"device={dev}")

    fail_plan = parse_fail(args.fail)
    losses = []
    for step in range(args.steps):
        batch = batch_for_step(cfg, step, args.global_batch, args.seq_len,
                               seed=args.seed)
        if step in fail_plan:
            # one-shot, injected straight into the live worker state (the
            # unified WorkerSpec vocabulary: fail_after_tasks)
            victims = fail_plan.pop(step)
            for w in victims:
                executor.workers[w].fail_after_tasks = 0
            print(f"step {step}: injecting fail-stop of workers {victims}")
        t0 = time.time()
        res = executor.train_step(params, opt_state, batch)
        dt = time.time() - t0
        if res.hung:
            print(f"step {step}: HUNG (non-robust DLS with failure) — "
                  f"restarting from checkpoint")
            raise SystemExit("no checkpoint to restart from; aborting")
        params, opt_state = res.params, res.opt_state
        losses.append(res.loss)
        extra = (f" dups={res.n_duplicates} wasted={res.wasted_tasks}"
                 if res.n_duplicates else "")
        print(f"step {step}: loss={res.loss:.4f} ({dt:.2f}s) "
              f"workers={len(res.survivors)}{extra}")
        shrink_to_survivors(executor)
    print(f"done: {len(losses)} steps, first loss {losses[0]:.4f}, "
          f"last loss {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
