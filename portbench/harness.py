"""One run of a cell: set-up, the measured window of closed loops, the
metrics, and the comparison that decides ``correct``.

The window drives ``repro_torch.runtime.RDLBServeExecutor.serve`` in
closed loops: each loop builds a fresh executor on the same model and
weights, submits the mix's requests and runs one threaded ``serve`` to
its end, with the mix's fail-stop (replica 1 stops at its next
assignment after 2 requests, keeping the chunk it holds), so the loop
ends only because rDLB re-issues that chunk.  Loops start back to back
until ``seconds`` have passed; the last one runs to its end, and the
window ends with it, so every metric reads whole loops.

From outside the program the harness records: when the engine commits
each request (the request object's ``output`` setter), each chunk run's
tokens (a wrapper of the executor's chunk decode), and each executed
group's rows, shape, wall seconds and prefill seconds (wrappers of the
``FusedGenerator`` and of ``model.prefill``).  A traced run also keeps
the engine's flight recorder (``ExecutionSpec.trace``) of each loop and
a ``torch.profiler`` trace of the window's first loop, with host spans
(chunk, group, prefill, decode step) of every thread beside it.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import importlib.util
import json
import os
import pathlib
import sys
import threading
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.kernels import dispatch
from repro_torch.models.common import ParamTree
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve_executor import RDLBServeExecutor, Request

from portbench import judge, profiling, traffic, weights as weights_mod

HERE = pathlib.Path(__file__).resolve().parent
#: modules whose presence after the window refuses the run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
FAULTS = ("token", "state")


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


_MODULES: dict = {}


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, imported once."""
    key = (kind, name)
    if key not in _MODULES:
        path = HERE / kind / f"{name}.py"
        mod_name = "portbench._" + kind + "_" + "".join(
            c if c.isalnum() else "_" for c in name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def process_age_s() -> float | None:
    """Seconds since this process started (Linux ``/proc``), or None."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def forbidden_modules(names=FORBIDDEN) -> list:
    """Loaded modules whose top-level name is one of ``names`` (the name
    before the first dot, compared whole: ``repro_torch`` is not
    ``repro``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in names)


class TimedRequest(Request):
    """A request that notes when, and how often, the engine commits it
    (the engine's commit writes ``output``)."""

    @property
    def output(self):
        return self.__dict__.get("_output")

    @output.setter
    def output(self, value):
        if value is not None:
            self.__dict__["commits"] = self.__dict__.get("commits", 0) + 1
            self.__dict__.setdefault("commit_t", time.perf_counter())
        self.__dict__["_output"] = value


def spanned(fn, spans, kind: str):
    """``fn`` noting (start, end, kind) in Unix nanoseconds, the
    profiler's clock, on ``spans`` (a traced run's)."""
    def run(*args, **kw):
        t0 = time.time_ns()
        try:
            return fn(*args, **kw)
        finally:
            spans.append((t0, time.time_ns(), kind))
    return run


class GroupSpans:
    """Stands in for the executor's ``FusedGenerator``: times each group
    and logs its rows, shape and prefill seconds (set by ``timed_prefill``
    on the same thread); with ``fault="token"`` it alters the last
    served token of every group (the fault tests)."""

    def __init__(self, generator, log: list, tls, fault=None, vocab=0,
                 spans=None):
        self.generator, self.log, self.tls = generator, log, tls
        self.fault, self.vocab = fault, vocab
        if spans is not None:
            self.generator = spanned(generator, spans, "group")

    def __call__(self, params, prompts, max_new):
        self.tls.prefill_s = 0.0
        t0 = time.perf_counter()
        out = self.generator(params, prompts, max_new)
        t1 = time.perf_counter()
        self.log.append(dict(rows=int(prompts.shape[0]),
                             S=int(prompts.shape[1]), n=int(max_new),
                             wall_s=t1 - t0, prefill_s=self.tls.prefill_s))
        if self.fault == "token":
            out = out.copy()
            out[:, -1] = (out[:, -1] + 1) % self.vocab
        return out


def timed_prefill(prefill, tls):
    def run(*args, **kw):
        t0 = time.perf_counter()
        try:
            return prefill(*args, **kw)
        finally:
            tls.prefill_s = time.perf_counter() - t0
    return run


def stale_state(decode_step):
    """A decode step that returns its cache as it found it (the fault
    tests): the step computes on a copy."""
    def run(params, cache, tokens, pos):
        logits, _ = decode_step(params, copy.deepcopy(cache), tokens, pos)
        return logits, cache
    return run


def recorded_chunks(generate, completions: dict):
    """The executor's chunk decode, noting each returned request's
    tokens and return time."""
    def run(reqs):
        out = generate(reqs)
        t = time.perf_counter()
        for rid, toks in out.items():
            completions.setdefault(rid, []).append((t, toks))
        return out
    return run


class Cell:
    """A cell's configuration, mix, limits and model (no weights)."""

    def __init__(self, config: str, traffic_name: str, limits: str | None):
        self.config = load_json("configs", config)
        self.mix = load_json("traffic", traffic_name)
        self.limits = load_json("limits", limits) if limits else {}
        self.model_dict = {**self.config["model"],
                           **self.config.get("port_constants", {})}
        self.model_cfg = ModelConfig.from_reference(self.config["model"])
        self.model = build_model(self.model_cfg)
        self.ref = load_module("reference", self.config["family"])
        self.flops = load_module("counts", self.config["family"])
        self.vocab = self.model_cfg.vocab_size
        self.fail_at = {int(k): int(v)
                        for k, v in self.mix.get("fail_at", {}).items()}

    def spec(self, trace: bool):
        m = self.mix
        spec = api.serve_spec(technique=m["technique"],
                              n_workers=m["workers"],
                              rdlb_enabled=m["rdlb"], threaded=True)
        return spec.override("execution.trace", True) if trace else spec


class Runner:
    """The model and weights of one seed, and the loops run on them."""

    def __init__(self, cell: Cell, seed: int, device, *, trace=False,
                 fault=None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.trace, self.fault = trace, fault
        self.weights = weights_mod.draw(cell.model.param_specs(),
                                        cell.config["init"], seed,
                                        self.device)
        self.params = ParamTree(self.weights)
        self.tls = threading.local()
        #: (start, end, kind) host spans of every thread (traced runs)
        self.spans: list | None = [] if trace else None
        model = cell.model
        prefill = type(model).prefill.__get__(model)
        step = type(model).decode_step.__get__(model)
        if fault == "state":
            step = stale_state(step)
        if trace:
            prefill = spanned(prefill, self.spans, "prefill")
            step = spanned(step, self.spans, "decode_step")
        model.prefill = timed_prefill(prefill, self.tls)
        model.decode_step = step
        self.spec = cell.spec(trace)
        self.engine_stats: list = []

    def loop(self, index: int, *, profile: bool = False,
             cap_new: int | None = None) -> dict:
        """Run loop ``index`` of this seed's traffic to its end; with
        ``cap_new`` each request serves at most that many tokens (the
        warm-up: every prompt length's prefill and a decode step)."""
        cell = self.cell
        reqs = [TimedRequest(rid=i, prompt=p,
                             max_new_tokens=min(n, cap_new or n))
                for i, (p, n) in enumerate(
                    traffic.loop(cell.mix, self.seed, index, cell.vocab))]
        ex = RDLBServeExecutor(cell.model, self.params, spec=self.spec)
        groups: list = []
        completions: dict = {}
        ex._fused = GroupSpans(ex._fused, groups, self.tls, self.fault,
                               cell.vocab, self.spans)
        chunk = ex._generate_chunk
        if self.spans is not None:
            chunk = spanned(chunk, self.spans, "chunk")
        ex._generate_chunk = recorded_chunks(chunk, completions)
        if profile:
            from torch.profiler import ProfilerActivity, profile as tprof
            self.spans.clear()
            prof = tprof(activities=[ProfilerActivity.CUDA
                                     if self.device.type == "cuda"
                                     else ProfilerActivity.CPU])
        with prof if profile else contextlib.nullcontext():
            t0 = time.perf_counter()
            stats = ex.serve(reqs, fail_at=cell.fail_at)
            t1 = time.perf_counter()
            if profile and self.device.type == "cuda":
                torch.cuda.synchronize()
        out = dict(t0=t0, t1=t1, requests=reqs, completions=completions,
                   groups=groups, n_duplicates=stats.n_duplicates,
                   hung=stats.hung)
        if profile:
            out["profile"] = dict(profiling.read(prof, cell.config["sites"],
                                                 self.spans), span_s=t1 - t0)
            out["read_s"] = time.perf_counter() - t1
        if self.engine_stats:
            tr = self.engine_stats.pop().trace
            if tr is not None:
                busy = np.mean(tr.utilization(100)["busy"])
                lo, hi = tr.span()
                out["worker_busy"] = (float(busy), float(hi - lo))
        return out

    @contextlib.contextmanager
    def keep_engine_stats(self):
        """While inside, ``repro_torch.api.run`` hands this runner the
        EngineStats of each serve (the flight recorder rides on it)."""
        original = api.run

        def run(spec, eng):
            st = original(spec, eng)
            self.engine_stats.append(st)
            return st
        api.run = run
        try:
            yield
        finally:
            api.run = original


def window(runner: Runner, seconds: float) -> tuple[list, float, float]:
    """Whole loops back to back (numbers 1, 2, ...; the warm-up is loop
    0), a new one started while fewer than ``seconds`` have passed; the
    window ends when the last one does -> (loops, window start, window
    end)."""
    loops = []
    t_start = time.perf_counter()
    with (runner.keep_engine_stats() if runner.trace
          else contextlib.nullcontext()):
        while time.perf_counter() < t_start + seconds:
            loops.append(runner.loop(1 + len(loops),
                                     profile=runner.trace and not loops))
    return loops, t_start, time.perf_counter()


def record(cell: Cell, loops: list, t_start: float, t_end: float,
           setup_s: float | None) -> dict:
    """What the metric modules read (see ``metrics/``)."""
    commits = []
    for lp in loops:
        for r in lp["requests"]:
            t = r.__dict__.get("commit_t")
            if t is not None:
                commits.append(dict(S=len(r.prompt), n=int(r.max_new_tokens),
                                    since_loop_s=t - lp["t0"]))
    trace = next((lp["profile"] for lp in loops if "profile" in lp), None)
    if trace is not None:
        trace = dict(trace, groups=next(lp["groups"] for lp in loops
                                        if "profile" in lp))
    # reading the profile is the harness's work, not the program's
    read_s = sum(lp.get("read_s", 0.0) for lp in loops)
    return dict(
        model=cell.model_dict, window_s=t_end - t_start - read_s,
        setup_s=setup_s,
        flops=cell.flops, commits=commits,
        loops=[dict(n_requests=len(lp["requests"]),
                    n_committed=sum(r.output is not None
                                    for r in lp["requests"]),
                    n_duplicates=lp["n_duplicates"], hung=lp["hung"],
                    span_s=lp["t1"] - lp["t0"],
                    worker_busy=lp.get("worker_busy"))
               for lp in loops],
        groups=[g for lp in loops for g in lp["groups"]],
        trace=trace)


def compute_metrics(names: list, rec: dict, units: dict) -> dict:
    out = {}
    for name in names:
        value = load_module("metrics", name).compute(rec)
        if value is not None:
            out[name] = dict(value=value, unit=units[name])
    return out


def judge_run(runner: Runner, loops: list, *, controls=()) -> dict:
    """The numbers compared (each with its limit) and the readings of
    any precision ``controls``; frees the program's state first."""
    cell = runner.cell
    faults = judge.commit_faults(loops)
    reqs = [r for lp in loops for r in lp["requests"]]
    for lp in loops:                      # the program's state goes
        lp["completions"].clear()
    gc.collect()
    if runner.device.type == "cuda":
        torch.cuda.empty_cache()
    chosen = judge.sample(reqs, cell.mix["check_tokens"], runner.seed)
    g, exact = judge.served_gaps(cell.ref, runner.weights, cell.model_dict,
                                 chosen, runner.device)
    checks = {k: dict(value=v, limit=0) for k, v in faults.items()}
    checks["max_gap"] = dict(value=float(g.max()) if len(g) else None,
                             limit=cell.limits.get("max_gap"))
    readings = dict(served_tokens=int(len(g)), requests=len(chosen))
    for prec in controls:
        cg = judge.control_gaps(cell.ref, runner.weights, cell.model_dict,
                                chosen, runner.device, prec, exact)
        readings[f"control_{prec}_max_gap"] = float(cg.max())
    return dict(checks=checks, readings=readings)


def sites_check(cell: Cell, loops: list) -> dict:
    """Kernel sites the window's work runs that did not launch on the
    card: the config's ``"prefill"`` sites always, its ``"decode"`` ones
    when some group decoded."""
    decoded = any(g["n"] > 1 for lp in loops for g in lp["groups"])
    want = [s for s, phase in cell.config["sites"].items()
            if phase == "prefill" or decoded]
    off = [s for s in want
           if dispatch.launches(s) == 0
           or dispatch.status(s).get("path") != "cuda"]
    return dict(value=len(off), limit=0, sites=off)


def passed(checks: dict) -> bool:
    for c in checks.values():
        if c["value"] is None or c["limit"] is None or c["value"] > c["limit"]:
            return False
    return True
