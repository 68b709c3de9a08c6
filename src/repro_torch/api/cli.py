"""``python -m repro_torch`` — run a simulation/benchmark from a JSON spec file.

The scenario-as-data payoff: a run (or a whole benchmark grid) is a
diffable JSON file, executed without writing any Python.

File schema::

    {
      "workload": {"kind": "uniform", "n": 1024, "t": 0.01}
                | {"kind": "normal",  "n": 1024, "mean": 0.01,
                   "sd": 0.004, "seed": 0}
                | {"kind": "psia", "n": null}          # null = paper N
                | {"kind": "mandelbrot", "n": 16384},
      "spec":   { ...RunSpec.to_dict()... },           # the base spec
      "sweep":  [ {"name": "fail_1/FAC",
                   "overrides": {"scheduling.technique": "FAC",
                                 "cluster": {...ClusterSpec...}}}, ... ],
      "metric": "t_par" | "resilience",
      "baseline_scenario": "baseline"                  # for resilience
    }

``sweep`` is optional (absent = run the base spec once).  An override
value may be a scalar (dotted-path ``spec.override``) or, for the
section keys ``scheduling``/``robustness``/``cluster``/``execution``/
``adaptive``, a full section dict.  With ``metric: "resilience"``,
sweep entry names must be ``<scenario>/<technique>`` and the FePIA
resilience ρ_res is computed per scenario against ``baseline_scenario``
— exactly the ``benchmarks/fig4_resilience.py`` data points.

Usage::

    python -m repro_torch run --spec runs/fig4_fail1.json [--dry-run] [--csv f]
    python -m repro_torch run --spec f.json --device cpu  # no GPU needed
    python -m repro_torch run --spec f.json --trace out.json   # flight recorder
    python -m repro_torch run --spec f.json --emit-json rec.json
    python -m repro_torch show --spec runs/fig4_fail1.json
    python -m repro_torch trace summarize out.json
    python -m repro_torch trace diff a.json b.json

``--device`` (default ``cuda``) is where the Mandelbrot workload's
escape counts are computed; the simulation itself runs on the host.
``trace calibrate`` and ``--emit-json`` of a traced run need
``repro.obs``, which is not ported yet (ROADMAP.md queue A, item A9):
they raise ``NotImplementedError``.

``--trace`` forces the flight recorder on (``execution.trace``) and
exports each run as Chrome-trace-event JSON — open it at
https://ui.perfetto.dev.  ``--emit-json`` dumps the full run record(s)
(SimResult.to_dict, trace included when recorded).  ``trace summarize``
/ ``trace diff`` re-derive metrics from exported files.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np

from repro_torch.api import facade
from repro_torch.api.spec import RunSpec

SECTION_KEYS = ("scheduling", "robustness", "cluster", "execution",
                "adaptive", "n_tasks", "name")


def load_workload(w: dict, device=None) -> np.ndarray:
    kind = w.get("kind", "uniform")
    n = w.get("n")
    if kind == "uniform":
        return np.full(int(n or 1024), float(w.get("t", 1.0)))
    if kind == "normal":
        rng = np.random.default_rng(int(w.get("seed", 0)))
        tt = rng.normal(float(w.get("mean", 0.01)),
                        float(w.get("sd", 0.004)), int(n or 1024))
        return np.abs(tt) + 1e-4
    if kind == "psia":
        from repro_torch.apps import psia
        return psia.task_times(int(n) if n else psia.PAPER_N)
    if kind == "mandelbrot":
        from repro_torch.apps import mandelbrot
        return mandelbrot.task_times(int(n) if n else 16_384,
                                     device=device)
    raise ValueError(f"unknown workload kind {kind!r}")


def apply_overrides(spec: RunSpec, overrides: dict) -> RunSpec:
    """Scalar dotted-path overrides plus whole-section replacement."""
    d = None
    for path, value in (overrides or {}).items():
        if path in SECTION_KEYS and isinstance(value, (dict, list)):
            if d is None:
                d = spec.to_dict()
            d[path] = value
            continue
        if d is not None:               # flush section replacements first
            spec, d = RunSpec.from_dict(d), None
        spec = spec.override(path, value)
    return RunSpec.from_dict(d) if d is not None else spec


def load_run_file(path: str, device=None):
    """-> (task_times, [(name, RunSpec)], metric, baseline_scenario)."""
    with open(path) as f:
        doc = json.load(f)
    base = RunSpec.from_dict(doc.get("spec", {}))
    tt = load_workload(doc.get("workload", {}), device)
    sweep = doc.get("sweep")
    if sweep:
        entries = [(e.get("name", f"run{i}"),
                    apply_overrides(base, e.get("overrides", {})))
                   for i, e in enumerate(sweep)]
    else:
        entries = [(base.name or "run", base)]
    return (tt, entries, doc.get("metric", "t_par"),
            doc.get("baseline_scenario", "baseline"))


def _suffixed(path: str, name: str, many: bool) -> str:
    """out.json -> out.<name>.json when a sweep has several entries."""
    if not many:
        return path
    stem, dot, ext = path.rpartition(".")
    safe = name.replace("/", "_")
    return f"{stem}.{safe}{dot}{ext}" if dot else f"{path}.{safe}"


def cmd_run(args) -> int:
    tt, entries, metric, baseline = load_run_file(args.spec, args.device)
    tracing = bool(getattr(args, "trace", ""))
    if tracing:
        entries = [(n, s.override("execution.trace", True))
                   for n, s in entries]
    if args.dry_run:
        for name, spec in entries:
            facade.build(spec, facade.engine.WorkerBackend(),
                         n_tasks=len(tt))      # validates the full spec
            print(f"dryrun,{name},ok,N={len(tt)},"
                  f"P={spec.cluster.n_workers},"
                  f"technique={spec.scheduling.technique}")
        print(f"dryrun,total,{len(entries)} run(s) validated")
        return 0
    rows = []
    many = len(entries) > 1
    for name, spec in entries:
        r = facade.simulate(spec, tt)
        rows.append((name, r))
        print(f"run,{name},{spec.scheduling.technique},"
              f"{spec.cluster.name or spec.name or 'cluster'},"
              f"{int(spec.robustness.rdlb_enabled)},{r.t_par},"
              f"{r.n_duplicates},{r.wasted_tasks},{int(r.hang)}")
        if tracing and r.trace is not None:
            from repro_torch.core import trace as trc
            out = _suffixed(args.trace, name, many)
            trc.save_chrome(r.trace, out)
            print(f"trace,{name},{out},{len(r.trace)} events")
        if getattr(args, "emit_json", ""):
            out = _suffixed(args.emit_json, name, many)
            rec = r.to_dict()
            if r.trace is not None:
                raise NotImplementedError(
                    "--emit-json of a traced run needs repro.obs."
                    "run_telemetry, not ported to repro_torch yet: "
                    "ROADMAP.md queue A, item A9")
            with open(out, "w") as f:
                json.dump(rec, f)
                f.write("\n")
            print(f"record,{name},{out}")
    if metric == "resilience":
        for line in resilience_lines(rows, baseline):
            print(line)
    if args.csv:
        import csv
        with open(args.csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["name", "technique", "scenario", "rdlb", "t_par",
                        "n_duplicates", "wasted_tasks", "hung"])
            for name, r in rows:
                w.writerow([name, r.technique, r.scenario, int(r.rdlb),
                            r.t_par, r.n_duplicates, r.wasted_tasks,
                            int(r.hang)])
    return 0


def resilience_lines(rows, baseline_scenario: str) -> list:
    """FePIA ρ_res per (scenario, technique) — the fig4 data points.

    Row names must be ``<scenario>/<technique>``; the baseline t_par of
    each technique comes from the ``<baseline_scenario>/...`` rows.
    """
    from repro_torch.core import robustness
    by: dict = {}
    for name, r in rows:
        scen, _, tech = name.rpartition("/")
        by.setdefault(scen, {})[tech] = r.t_par
    tb = by.get(baseline_scenario)
    out = []
    if not tb:
        return [f"resilience,ERROR,no '{baseline_scenario}/<tech>' rows"]
    for scen in sorted(by):
        if scen == baseline_scenario:
            continue
        tf = {t: v for t, v in by[scen].items() if t in tb}
        rho = robustness.resilience(tf, {t: tb[t] for t in tf})
        out += [f"resilience,{scen},{t},{rho[t]:.4f}"
                for t in sorted(rho)]
    return out


def cmd_trace(args) -> int:
    """``trace summarize <file>`` / ``trace diff <a> <b>`` /
    ``trace calibrate <file> --spec in.json -o calibrated.json`` on
    exported trace files (Chrome JSON with the embedded "repro" record,
    bare Trace.to_dict dumps, or --emit-json run records)."""
    from repro_torch.core import trace as trc
    if args.action == "summarize":
        print(trc.summarize(trc.load_trace(args.files[0])))
        return 0
    if args.action == "calibrate":
        return _trace_calibrate(args, trc)
    if len(args.files) < 2:
        print("trace diff needs two files", file=sys.stderr)
        return 2
    print(trc.diff(trc.load_trace(args.files[0]),
                   trc.load_trace(args.files[1])))
    return 0


def _trace_calibrate(args, trc) -> int:
    """Fitting a calibrated RunSpec from a trace needs
    ``repro.obs.calibrate_trace``, not ported yet."""
    raise NotImplementedError(
        "trace calibrate needs repro.obs.calibrate_trace, not ported to "
        "repro_torch yet: ROADMAP.md queue A, item A9")


def cmd_show(args) -> int:
    tt, entries, metric, baseline = load_run_file(args.spec, args.device)
    print(f"workload: {len(tt)} tasks, total {tt.sum():.4g}s nominal")
    print(f"metric: {metric}" + (f" (baseline={baseline})"
                                 if metric == "resilience" else ""))
    for name, spec in entries:
        print(f"--- {name} ---")
        print(spec.to_json())
    return 0


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="Run rDLB simulations/benchmarks from JSON RunSpecs.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run", help="execute a spec file")
    p_run.add_argument("--spec", required=True, help="JSON spec file")
    p_run.add_argument("--dry-run", action="store_true",
                       help="validate and build without running")
    p_run.add_argument("--csv", default="", help="also write rows to CSV")
    p_run.add_argument("--trace", default="",
                       help="record the run and export Chrome/Perfetto "
                            "trace JSON to this path (sweeps get a "
                            "per-entry suffix)")
    p_run.add_argument("--emit-json", default="",
                       help="dump the full run record(s) as JSON "
                            "(SimResult.to_dict, trace included)")
    p_run.add_argument("--device", default=None,
                       help="where the mandelbrot workload is computed: "
                            "cuda (default) or cpu")
    p_run.set_defaults(fn=cmd_run)
    p_show = sub.add_parser("show", help="pretty-print a spec file")
    p_show.add_argument("--spec", required=True)
    p_show.add_argument("--device", default=None,
                        help="cuda (default) or cpu, as for run")
    p_show.set_defaults(fn=cmd_show)
    p_tr = sub.add_parser("trace",
                          help="inspect exported trace files")
    p_tr.add_argument("action", choices=("summarize", "diff", "calibrate"))
    p_tr.add_argument("files", nargs="+", help="trace JSON file(s)")
    p_tr.add_argument("--spec", default="",
                      help="calibrate: declared spec (bare RunSpec JSON "
                           "or a run file with 'spec'/'workload' keys)")
    p_tr.add_argument("--workload", default="",
                      help="calibrate: standalone workload JSON override "
                           "(same schema as a run file's 'workload')")
    p_tr.add_argument("-o", "--out", default="",
                      help="calibrate: save the calibrated RunSpec here")
    p_tr.set_defaults(fn=cmd_trace)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
