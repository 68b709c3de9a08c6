"""Dry run: every (architecture x input shape) step on ``meta`` tensors,
counted, without allocating a single parameter on any device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all

The port's counterpart of ``repro.launch.dryrun``, which lowers and
compiles each cell for TPU meshes.  Here each cell's step
(``launch.steps``: a training step with its microbatches and optimizer,
a prefill, or one decode step against a full cache) runs eagerly on
``meta`` tensors under ``launch.op_analysis.Counter``, and the record
holds: FLOPs, unfused bytes (every op's inputs and outputs) and the
minimum bytes (parameters, optimizer state, cache and batch, each read
once and the state written once), the bytes of each of those, the peak
of the step's own live tensors (activations, gradients, temporaries),
whether the parameters and optimizer state, and then those plus the
peak, fit one card's 80 GB, and the roofline terms on the card's
spec-sheet peaks (``launch.mesh``) with the dominant one.  A cell that
needs sub-quadratic attention is skipped as N/A by design, as the
reference's.  Artifacts: ``artifacts/dryrun_torch/<arch>__<shape>.json``
(``<arch>__<shape>__<tag>.json`` with ``--tag``) and ``summary.json``
(``artifacts/`` is not tracked).

The reference's tuning flags apply to every cell of a run, as
``ModelConfig.replace`` overrides, and each record holds the overrides
applied and the microbatches used: ``--flash-threshold N``
(``flash_threshold``), ``--causal-skip`` (``flash_causal_skip``),
``--attn-bf16`` (``attn_scores_bf16``), ``--parallelism``,
``--moe-group N`` (``moe_group_size``), ``--remat POLICY``
(``remat_policy``); ``--microbatches N`` replaces a training cell's own
count (0 keeps it).  The reference's ``--mesh`` (single pod, multi pod)
is left out: one card has no mesh (``launch.mesh``).
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, Shape, applicable_shapes,
                                 get_config, input_specs, train_config)
from repro_torch.launch import mesh
from repro_torch.launch.op_analysis import (Counter, dominant_term,
                                            roofline_terms)
from repro_torch.launch.steps import (abstract_state, make_serve_step,
                                      make_train_step, state_bytes)
from repro_torch.models.common import tree_leaves

ARTIFACTS = (Path(__file__).resolve().parents[3] / "artifacts"
             / "dryrun_torch")


def measure(cfg, shape: Shape, *, microbatches: int = 1,
            optimizer: str = "adamw",
            overrides: Optional[dict] = None) -> dict:
    """Count one step of ``cfg`` (with ``overrides`` applied by
    ``cfg.replace``) at ``shape`` on ``meta`` tensors."""
    if overrides:
        cfg = cfg.replace(**overrides)
    batch_bytes = cache_bytes = opt_bytes = 0
    t0 = time.perf_counter()
    if shape.kind == "train":
        ts = make_train_step(cfg, num_microbatches=microbatches,
                             optimizer=optimizer)
        specs = input_specs(cfg, shape, ts.model)
        params, opt = abstract_state(ts)
        opt_bytes = state_bytes(opt)
        batch_bytes = state_bytes(specs)
        with torch.no_grad(), Counter() as c:
            ts(params, opt, specs)
    else:
        ss = make_serve_step(cfg)
        specs = input_specs(cfg, shape, ss.model)
        params = ss.model.init(0, device="meta")
        with Counter() as c:
            if shape.kind == "prefill":
                ss.prefill_fn(params, specs)
                batch_bytes = state_bytes(specs)
            else:
                ss.decode_fn(params, specs["cache"], specs["tokens"],
                             shape.seq_len - 1)
                cache_bytes = state_bytes(specs["cache"])
                batch_bytes = state_bytes(specs["tokens"])
    params_bytes = state_bytes(params)
    # state read once, and written once where the step updates it
    minimum = (params_bytes + batch_bytes + cache_bytes
               + (params_bytes + 2 * opt_bytes if shape.kind == "train"
                  else 0))
    resident = params_bytes + opt_bytes + cache_bytes + batch_bytes
    terms = roofline_terms(c.flops, c.unfused_bytes,
                           peak_flops=mesh.PEAK_FLOPS_BF16,
                           hbm_bw=mesh.HBM_BW)
    return {
        "seconds": round(time.perf_counter() - t0, 2),
        "params": sum(t.numel() for t in tree_leaves(params)),
        "flops": c.flops, "unfused_bytes": c.unfused_bytes,
        "min_bytes": float(minimum),
        "params_bytes": params_bytes, "opt_bytes": opt_bytes,
        "cache_bytes": cache_bytes, "batch_bytes": batch_bytes,
        "peak_step_bytes": c.peak_bytes,
        "fits_state": params_bytes + opt_bytes <= mesh.HBM_BYTES,
        "fits_with_activations":
            resident + c.peak_bytes <= mesh.HBM_BYTES,
        "roofline": terms, "dominant": dominant_term(terms),
        "t_memory_min": minimum / mesh.HBM_BW,
    }


def run_cell(arch: str, shape_name: str, *,
             overrides: Optional[dict] = None,
             microbatches: int = 0) -> dict:
    """The record of one cell at the reference's configuration with
    ``overrides``: for a training shape its optimizer, and its
    microbatches unless ``microbatches`` is set."""
    shape = SHAPES[shape_name]
    tc = train_config(arch)
    mb = microbatches or tc["num_microbatches"]
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind,
           "seq_len": shape.seq_len, "global_batch": shape.global_batch,
           "overrides": dict(overrides or {})}
    if shape.kind == "train":
        rec["microbatches"] = mb
    rec.update(measure(get_config(arch), shape, microbatches=mb,
                       optimizer=tc["optimizer"], overrides=overrides))
    rec["ok"] = True
    return rec


def run(archs, shapes, out_dir: Path, *, overrides: Optional[dict] = None,
        microbatches: int = 0, tag_suffix: str = "") -> tuple[list, int]:
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for arch in archs:
        app = applicable_shapes(get_config(arch))
        for shape_name in shapes:
            tag = f"{arch}__{shape_name}{tag_suffix}"
            if shape_name not in app:
                rec = {"arch": arch, "shape": shape_name, "ok": None,
                       "skip": "N/A-by-design (needs sub-quadratic attn)"}
                print(f"[skip] {tag}: {rec['skip']}", flush=True)
            else:
                try:
                    rec = run_cell(arch, shape_name, overrides=overrides,
                                   microbatches=microbatches)
                    t = rec["roofline"]
                    print(f"[ok]   {tag}: {rec['seconds']}s "
                          f"flops={rec['flops']:.3e} "
                          f"unfused={rec['unfused_bytes']:.3e}B "
                          f"min={rec['min_bytes']:.3e}B "
                          f"peak={rec['peak_step_bytes']:.3e}B "
                          f"fits={rec['fits_with_activations']} "
                          f"dom={rec['dominant']} t=({t['t_compute']:.4f},"
                          f"{t['t_memory']:.4f})s", flush=True)
                except Exception as e:  # noqa: BLE001 — recorded
                    rec = {"arch": arch, "shape": shape_name, "ok": False,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"[FAIL] {tag}: {rec['error']}", flush=True)
            (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=2))
            results.append(rec)
    (out_dir / "summary.json").write_text(json.dumps(results, indent=2))
    n_fail = sum(1 for r in results if r.get("ok") is False)
    print(f"\n{len(results)} cells, {n_fail} failures")
    return results, n_fail


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all",
                    help="arch id | comma list | all")
    ap.add_argument("--shape", default="all",
                    help="shape name | comma list | all")
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--flash-threshold", type=int, default=0)
    ap.add_argument("--causal-skip", action="store_true")
    ap.add_argument("--attn-bf16", action="store_true")
    ap.add_argument("--parallelism", default="")
    ap.add_argument("--moe-group", type=int, default=0)
    ap.add_argument("--remat", default="")
    ap.add_argument("--microbatches", type=int, default=0)
    args = ap.parse_args(argv)
    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    overrides = {}
    if args.flash_threshold:
        overrides["flash_threshold"] = args.flash_threshold
    if args.causal_skip:
        overrides["flash_causal_skip"] = True
    if args.attn_bf16:
        overrides["attn_scores_bf16"] = True
    if args.parallelism:
        overrides["parallelism"] = args.parallelism
    if args.moe_group:
        overrides["moe_group_size"] = args.moe_group
    if args.remat:
        overrides["remat_policy"] = args.remat
    _, n_fail = run(archs, shapes, Path(args.out),
                    overrides=overrides or None,
                    microbatches=args.microbatches,
                    tag_suffix=f"__{args.tag}" if args.tag else "")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
