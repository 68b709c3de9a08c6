"""Robust training from the command line: the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --smoke --steps 5 --n-workers 4 --n-tasks 8 --technique FAC \
        --fail "2:1" --ckpt-dir /tmp/ckpt [--device cpu]

Wires together: config -> model (weights from the port's seeded init,
``--seed``) -> synthetic data -> rDLB executor -> checkpoint manager
(+ restart) -> elastic shrink after failures.  ``--arch`` takes the dense
family (olmo-1b, ...) and rwkv6-1.6b.  The workers run as threads on the
card unless ``--device cpu`` is given; without ``--smoke`` the config is
the full-width one, in its own dtype (bfloat16).

``--fail "STEP:W1,W2"`` kills workers W1,W2 (fail-stop) during STEP —
training continues (rDLB) and the next step runs on the survivors.
``--no-rdlb`` reproduces the paper's hang: the CLI abandons the step
and restarts from the last checkpoint (``--ckpt-dir``, written every
``--ckpt-interval`` steps), which is the checkpoint/restart baseline of
§3.1; without a checkpoint it aborts.
"""

from __future__ import annotations

import argparse
import time

from repro_torch import api
from repro_torch.checkpoint import CheckpointManager
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
    ap.add_argument("--ckpt-interval", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

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

    ckpt = (CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval)
            if args.ckpt_dir else None)
    start_step = 0
    if ckpt is not None:
        restored = ckpt.restore_latest({"params": params, "opt": opt_state},
                                       device=dev)
        if restored is not None:
            (state, start_step) = restored
            params, opt_state = state["params"], state["opt"]
            print(f"restored checkpoint at step {start_step}")

    fail_plan = parse_fail(args.fail)
    step = start_step
    losses = []
    while step < args.steps:
        batch = batch_for_step(cfg, step, args.global_batch, args.seq_len,
                               seed=args.seed)
        if step in fail_plan:
            # one-shot: a failed node does not re-fail after restart.
            # Injected straight into the live worker state (the unified
            # WorkerSpec vocabulary: fail_after_tasks).
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
            # restore_latest waits on any in-flight async save
            restored = (ckpt.restore_latest({"params": params,
                                             "opt": opt_state}, device=dev)
                        if ckpt is not None else None)
            if restored is None:
                raise SystemExit("no checkpoint to restart from; aborting")
            (state, step) = restored
            params, opt_state = state["params"], state["opt"]
            print(f"restored checkpoint at step {step}")
            executor.reset_workers()
            continue
        params, opt_state = res.params, res.opt_state
        losses.append(res.loss)
        extra = (f" dups={res.n_duplicates} wasted={res.wasted_tasks}"
                 if res.n_duplicates else "")
        print(f"step {step}: loss={res.loss:.4f} ({dt:.2f}s) "
              f"workers={len(res.survivors)}{extra}")
        shrink_to_survivors(executor)
        step += 1
        if ckpt is not None:
            ckpt.maybe_save(step, {"params": params, "opt": opt_state})
    if ckpt is not None:
        ckpt.wait()
    print(f"done: {len(losses)} steps, first loss {losses[0]:.4f}, "
          f"last loss {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
