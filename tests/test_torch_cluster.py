"""The port's process-cluster runtime (``repro_torch.cluster``) on the CPU.

A twin of each test of tests/test_cluster.py on ``repro_torch``, at the
same small sizes (SIGKILL of P-1 workers with every task committed
exactly once, SIGSTOP survival, guaranteed teardown, two-level groups,
both executors in process mode), then the port held against the
reference's own ``ClusterRun`` on the same spec: the original-chunk
partition and the exactly-once commit log (the reference's workers run
here as forked light runners), process-mode serving tokens (equal) and
training gradients (within 1e-5 of each leaf's largest magnitude: the
two packages sum in other orders) on float32 configs with the
reference's weights.  Then what the port adds: which runners spawn,
the forked-child guard, the children's kernel reports, and the serve
executor's ``slow`` overlay and ``max_rounds``.

Every process-mode spec gives ``stall_timeout`` and ``wall_timeout``, so
a hung child fails its test instead of running the suite out of time.
"""

import dataclasses
import functools
import json
import math
import multiprocessing
import os
import time

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro.core import simulator as jsimulator
from repro.models import build_model as jbuild
from repro.runtime.backends import FnBackend as JFnBackend
from repro.runtime.backends import TrainBackend as JTrainBackend
from repro.runtime.serve_executor import RDLBServeExecutor as JServe
from repro.runtime.serve_executor import Request as JRequest
from repro_torch import api, cluster
from repro_torch.apps import mandelbrot
from repro_torch.core import simulator
from repro_torch.data import batch_for_step
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_reference
from repro_torch.runtime import RDLBServeExecutor, Request
from repro_torch.runtime.backends import FnBackend, TrainBackend

# the reference donates its caches, which the CPU cannot use
pytestmark = pytest.mark.filterwarnings("ignore:Some donated buffers")


def _square(t):          # module-level: picklable for forked FnRunner
    return t * t


def counting_backend_of(base):
    """``base`` (a backend class) counting every commit per task id —
    the exactly-once probe (a duplicate result that slipped past the
    queue would bump a count to 2)."""
    class Counting(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.commits: dict[int, int] = {}

        def commit(self, chunk, wid, payload, newly):
            for t in newly:
                self.commits[t] = self.commits.get(t, 0) + 1
            super().commit(chunk, wid, payload, newly)
    return Counting


CountingBackend = counting_backend_of(FnBackend)
JCountingBackend = counting_backend_of(JFnBackend)


def assert_no_orphans():
    """No leaked children on EITHER spawn path: forked workers show up
    in multiprocessing.active_children(); spawned workers
    (``repro_torch.cluster._child``) only in /proc — scan for live
    children of this process running cluster code."""
    assert multiprocessing.active_children() == []
    me = os.getpid()
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().split()[3])
            if ppid != me:
                continue
            with open(f"/proc/{pid}/cmdline") as f:
                cmd = f.read().replace("\0", " ")
        except (FileNotFoundError, ProcessLookupError, ValueError):
            continue
        assert "cluster._child" not in cmd, f"orphan child {pid}: {cmd}"


def process(**kw) -> api.ExecutionSpec:
    kw.setdefault("stall_timeout", 10.0)
    kw.setdefault("wall_timeout", 60.0)
    return api.ExecutionSpec(mode="process", **kw)


# ------------------------------------------------------- acceptance demo
def test_sigkill_p_minus_1_exactly_once():
    """P=4 worker processes, N=200 tasks; 3 of 4 are SIGKILLed mid-run;
    every task completes exactly once, hung=False, within a bounded
    wall-clock budget — and the virtual twin of the same ClusterSpec
    predicts the same completion set."""
    P, N = 4, 200
    tt = np.full(N, 0.005)
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="FAC"),
        cluster=api.ClusterSpec(
            n_workers=P,
            workers=tuple([api.WorkerSpec()]
                          + [api.WorkerSpec(fail_time=0.12)] * (P - 1)),
            name="p_minus_1"),
        execution=process())

    backend = CountingBackend(task_fn=_square, task_times=tt)
    t0 = time.monotonic()
    eng = api.build(spec, backend, n_tasks=N)
    st = api.run(spec, eng)
    wall = time.monotonic() - t0

    assert not st.hung
    assert st.n_finished == N
    assert wall < 60.0 and st.t_wall < 60.0
    assert sorted(backend.commits) == list(range(N))
    assert all(c == 1 for c in backend.commits.values())
    assert backend.results == {t: t * t for t in range(N)}
    kills = [ev for ev in st.chaos_events if ev.action == "kill"]
    assert len(kills) == P - 1
    assert st.survivors == [0]
    assert st.n_duplicates >= 1

    vspec = spec.override("execution.mode", "virtual")
    veng = api.build(vspec, simulator.SimBackend(tt), n_tasks=N)
    vst = api.run(vspec, veng)
    assert not vst.hung and vst.n_finished == N
    virtual_completed = {t for t in range(N)
                         if veng.queue.flags[t] == 2}   # Flag.FINISHED
    assert set(backend.commits) == virtual_completed
    assert_no_orphans()


# ------------------------------------------------------------- parity
@pytest.mark.parametrize("technique", ["FAC", "GSS"])
def test_virtual_vs_process_original_chunk_parity(technique):
    """The process master drives the SAME RobustQueue, so the
    original-chunk partition of [0, N) is identical to Engine.run()."""
    N, P = 120, 4
    tt = np.full(N, 0.002)
    base = api.RunSpec(
        scheduling=api.SchedulingSpec(technique=technique),
        cluster=api.ClusterSpec(n_workers=P), execution=process())
    pst = api.run(base, api.build(base, simulator.SimBackend(tt),
                                  n_tasks=N))
    vspec = base.override("execution.mode", "virtual")
    vst = api.run(vspec, api.build(vspec, simulator.SimBackend(tt),
                                   n_tasks=N))
    assert not pst.hung and not vst.hung
    assert pst.n_finished == vst.n_finished == N
    assert originals(pst) == originals(vst)
    assert_no_orphans()


def originals(stats):
    return [(c.start, c.size) for c in stats.assignment_log
            if not c.duplicate]


# ------------------------------------------------------- SIGSTOP (Fig 1b)
def test_sigstop_hang_is_survived_and_reaped():
    P, N = 3, 60
    tt = np.full(N, 0.005)
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="FAC"),
        cluster=api.ClusterSpec(
            n_workers=P,
            workers=(api.WorkerSpec(), api.WorkerSpec(hang_time=0.05),
                     api.WorkerSpec())),
        execution=process())
    r = api.simulate(spec, tt)
    assert not r.hang and r.n_finished == N
    rv = api.simulate(spec.override("execution.mode", "virtual"), tt)
    assert not rv.hang and rv.n_finished == N
    assert_no_orphans()


def test_chaos_events_logged():
    P, N = 3, 60
    tt = np.full(N, 0.004)
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="FAC"),
        cluster=api.ClusterSpec(
            n_workers=P,
            workers=(api.WorkerSpec(), api.WorkerSpec(hang_time=0.04),
                     api.WorkerSpec(fail_time=0.04))),
        execution=process())
    st = api.run(spec, api.build(spec, simulator.SimBackend(tt), n_tasks=N))
    assert not st.hung
    actions = {(ev.wid, ev.action) for ev in st.chaos_events}
    assert (1, "stop") in actions
    assert (2, "kill") in actions
    assert all(ev.t >= 0.0 for ev in st.chaos_events)
    assert_no_orphans()


# ------------------------------------------------- guaranteed teardown
def test_nonrobust_kill_reports_hung_in_finite_time():
    P, N = 3, 90
    tt = np.full(N, 0.005)
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="FAC"),
        robustness=api.RobustnessSpec(rdlb_enabled=False),
        cluster=api.ClusterSpec(
            n_workers=P,
            workers=(api.WorkerSpec(), api.WorkerSpec(fail_time=0.05),
                     api.WorkerSpec())),
        execution=process(stall_timeout=2.0, wall_timeout=30.0))
    t0 = time.monotonic()
    r = api.simulate(spec, tt)
    assert r.hang and math.isinf(r.t_par)
    assert r.n_finished < N
    assert time.monotonic() - t0 < 30.0
    assert_no_orphans()


def _raise_on_three(t):
    if t == 3:
        raise RuntimeError("boom")
    return t


def test_errored_worker_raises_after_teardown():
    N = 8
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="SS"),
        cluster=api.ClusterSpec(n_workers=2),
        execution=process(stall_timeout=2.0, wall_timeout=30.0))
    backend = FnBackend(task_fn=_raise_on_three,
                        task_times=np.full(N, 0.01))
    eng = api.build(spec, backend, n_tasks=N)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="boom"):
        api.run(spec, eng)
    assert time.monotonic() - t0 < 30.0
    assert_no_orphans()


def test_long_inflight_chunk_is_not_a_stall():
    tt = np.full(4, 1.0)                    # 1 s per task >> 0.5 s stall
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="SS"),
        cluster=api.ClusterSpec(n_workers=2),
        execution=process(stall_timeout=0.5, wall_timeout=30.0))
    r = api.simulate(spec, tt)
    assert not r.hang and r.n_finished == 4
    assert_no_orphans()


# ------------------------------------------------------- spec round-trip
def test_process_spec_json_round_trip():
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="GSS", seed=7),
        robustness=api.RobustnessSpec(max_duplicates=2),
        cluster=api.ClusterSpec(
            n_workers=4,
            workers=(api.WorkerSpec(), api.WorkerSpec(hang_time=0.5),
                     api.WorkerSpec(speed=0.25),
                     api.WorkerSpec(fail_time=1.0, msg_latency=0.01))),
        execution=api.ExecutionSpec(mode="process", n_groups=2,
                                    stall_timeout=3.5, wall_timeout=42.0,
                                    max_fruitless_polls=77),
        n_tasks=64, name="round_trip")
    again = api.RunSpec.from_json(spec.to_json())
    assert again == spec
    assert again.execution.mode == "process"
    assert again.execution.n_groups == 2
    assert again.execution.wall_timeout == 42.0
    assert again.cluster.workers[1].hang_time == 0.5
    assert hash(again) == hash(spec)
    # and the reference reads the same JSON as the same spec
    assert japi.RunSpec.from_json(spec.to_json()).to_json() == spec.to_json()


def test_execution_spec_error_lists_all_modes():
    with pytest.raises(ValueError) as ei:
        api.ExecutionSpec(mode="warp")
    for m in ("virtual", "threaded", "process"):
        assert m in str(ei.value)
    with pytest.raises(ValueError) as ei2:
        api.ExecutionSpec.from_dict({"mode": "warp"})
    for m in ("virtual", "threaded", "process"):
        assert m in str(ei2.value)


def test_serve_slow_overlay_not_double_applied_in_process_mode():
    """with_serve_state encodes one 'slow' perturbation into BOTH speed
    and sleep_per_task; process mode realises both physically, so the
    executor's overlay skips the speed composition there."""
    base = api.ClusterSpec(n_workers=2)
    both = base.with_serve_state(slow={0: 0.5})
    assert both.workers[0].speed == pytest.approx(1.0 / 1.5)
    assert both.workers[0].sleep_per_task == pytest.approx(0.5)
    only_sleep = base.with_serve_state(slow={0: 0.5}, speed_compose=False)
    assert only_sleep.workers[0].speed == 1.0        # no duty-cycle
    assert only_sleep.workers[0].sleep_per_task == pytest.approx(0.5)


def test_build_is_side_effect_free_for_process_mode():
    spec = api.RunSpec(
        cluster=api.ClusterSpec(n_workers=3),
        execution=api.ExecutionSpec(mode="process"), n_tasks=16)
    eng = api.build(spec, FnBackend(task_times=np.ones(16)))
    assert isinstance(eng, cluster.ClusterRun)
    assert eng.queue.N == 16 and len(eng.workers) == 3
    assert_no_orphans()


# ----------------------------------------------------------- two-level
def test_two_level_group_master_completion():
    P, N = 4, 80
    tt = np.full(N, 0.003)
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="FAC"),
        cluster=api.ClusterSpec(n_workers=P),
        execution=process(n_groups=2))
    backend = CountingBackend(task_fn=_square, task_times=tt)
    st = api.run(spec, api.build(spec, backend, n_tasks=N))
    assert not st.hung and st.n_finished == N
    assert sorted(backend.commits) == list(range(N))
    assert all(c == 1 for c in backend.commits.values())
    assert backend.results == {t: t * t for t in range(N)}
    assert set(st.by_worker) & {0, 1} and set(st.by_worker) & {2, 3}
    assert_no_orphans()


def test_two_level_survives_losing_a_whole_group():
    P, N = 4, 32
    tt = np.full(N, 0.15)               # group chunk >> stall_timeout
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="FAC"),
        cluster=api.ClusterSpec(
            n_workers=P,
            workers=(api.WorkerSpec(fail_time=0.05),
                     api.WorkerSpec(fail_time=0.05),
                     api.WorkerSpec(), api.WorkerSpec())),
        execution=process(n_groups=2, stall_timeout=0.5))
    backend = CountingBackend(task_fn=_square, task_times=tt)
    st = api.run(spec, api.build(spec, backend, n_tasks=N))
    assert not st.hung and st.n_finished == N
    assert all(c == 1 for c in backend.commits.values())
    assert len(backend.commits) == N
    assert_no_orphans()


def test_two_level_nonrobust_baseline_stays_nonrobust():
    P, N = 4, 40
    tt = np.full(N, 0.04)
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="FAC"),
        robustness=api.RobustnessSpec(rdlb_enabled=False),
        cluster=api.ClusterSpec(
            n_workers=P,
            workers=(api.WorkerSpec(), api.WorkerSpec(),
                     api.WorkerSpec(hang_time=0.3),
                     api.WorkerSpec(hang_time=0.3))),
        execution=process(n_groups=2, stall_timeout=2.0, wall_timeout=8.0))
    t0 = time.monotonic()
    r = api.simulate(spec, tt)
    assert r.hang and r.n_finished < N
    assert time.monotonic() - t0 < 20.0
    assert_no_orphans()


def test_two_level_rejects_unrealizable_perturbations():
    spec = api.RunSpec(
        cluster=api.ClusterSpec(
            n_workers=2, workers=(api.WorkerSpec(fail_after_tasks=1),
                                  api.WorkerSpec())),
        execution=api.ExecutionSpec(mode="process", n_groups=2,
                                    wall_timeout=30.0),
        n_tasks=8)
    with pytest.raises(ValueError, match="fail_after_tasks"):
        api.build(spec, FnBackend(task_times=np.ones(8)))
    spec2 = spec.override(
        "cluster.workers",
        (api.WorkerSpec(msg_latency=0.01), api.WorkerSpec()))
    with pytest.raises(ValueError, match="msg_latency"):
        api.build(spec2, FnBackend(task_times=np.ones(8)))
    spec3 = api.RunSpec(
        cluster=api.ClusterSpec(n_workers=2),
        execution=api.ExecutionSpec(mode="process", n_groups=2),
        n_tasks=8)
    with pytest.raises(ValueError, match="wall_timeout"):
        api.build(spec3, FnBackend(task_times=np.ones(8)))
    with pytest.raises(ValueError, match="n_groups"):
        api.ExecutionSpec(mode="virtual", n_groups=2)


def test_two_level_worker_error_is_relayed_and_raised():
    N = 8
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="SS"),
        cluster=api.ClusterSpec(n_workers=2),
        execution=process(n_groups=2, stall_timeout=2.0, wall_timeout=10.0))
    backend = FnBackend(task_fn=_raise_on_three,
                        task_times=np.full(N, 0.01))
    with pytest.raises(RuntimeError, match="boom"):
        api.run(spec, api.build(spec, backend, n_tasks=N))
    assert_no_orphans()


def test_process_fail_after_tasks_kills_at_assignment():
    P, N = 2, 24
    tt = np.full(N, 0.004)
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="SS"),
        cluster=api.ClusterSpec(
            n_workers=P, workers=(api.WorkerSpec(),
                                  api.WorkerSpec(fail_after_tasks=3))),
        execution=process())
    backend = CountingBackend(task_fn=_square, task_times=tt)
    st = api.run(spec, api.build(spec, backend, n_tasks=N))
    assert not st.hung and st.n_finished == N
    assert all(c == 1 for c in backend.commits.values())
    assert any(ev.action == "kill_by_count" for ev in st.chaos_events)
    assert 1 not in st.survivors
    assert_no_orphans()


# ------------------------------------------ executors in process mode
CFG = ModelConfig(family="dense", n_layers=1, d_model=32, n_heads=2,
                  n_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32")


def test_train_executor_process_mode():
    """RDLBTrainExecutor with mode='process': microbatch gradients are
    computed in spawned worker processes and accumulated exactly-once by
    the master; the step equals the in-process virtual step (the same
    per-task gradients, reduced in the same order)."""
    from repro_torch.runtime import RDLBTrainExecutor
    model = build_model(CFG)
    params = model.init(0, device="cpu")
    batch = batch_for_step(CFG, 0, 4, 8)
    spec = (api.train_spec(technique="FAC", n_workers=2, n_tasks=4)
            .override("execution.mode", "process")
            .override("execution.stall_timeout", 120.0)
            .override("execution.wall_timeout", 300.0))
    ex = RDLBTrainExecutor(model, spec=spec, exact_accumulation=True)
    res = ex.train_step(params, ex.opt.init(params), batch)
    assert not res.hung
    assert np.isfinite(res.loss)
    assert sum(res.tasks_by_worker.values()) >= 4
    vex = RDLBTrainExecutor(model, spec=api.train_spec(
        technique="FAC", n_workers=2, n_tasks=4), exact_accumulation=True)
    vres = vex.train_step(params, vex.opt.init(params), batch)
    assert res.loss == pytest.approx(vres.loss, rel=1e-6)
    for a, b in zip(tree_leaves(res.params), tree_leaves(vres.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert_no_orphans()


def _reqs(cls, n=6):
    return [cls(i, np.arange(4, dtype=np.int32) + i % 3, max_new_tokens=2)
            for i in range(n)]


@pytest.mark.parametrize("batch_decode,fused_decode",
                         [(True, True), (False, False)])
def test_serve_executor_process_mode_token_parity(batch_decode, fused_decode,
                                                  monkeypatch):
    """RDLBServeExecutor with mode='process': replicas are real
    processes, decoding with the executor's two flags (the per-request,
    per-token loop too); outputs are token-identical to the in-process
    path and to a threaded run."""
    model = build_model(CFG)
    params = model.init(0, device="cpu")
    spec = (api.serve_spec(technique="SS", n_workers=2)
            .override("execution.mode", "process")
            .override("execution.stall_timeout", 120.0)
            .override("execution.wall_timeout", 300.0))
    shipped = []
    from_model = cluster.ServeTaskRunner.from_model

    def spy(*args, **kwargs):
        shipped.append(from_model(*args, **kwargs))
        return shipped[-1]

    monkeypatch.setattr(cluster.ServeTaskRunner, "from_model", spy)
    a = _reqs(Request)
    st = RDLBServeExecutor(model, params, spec=spec,
                           batch_decode=batch_decode,
                           fused_decode=fused_decode).serve(a)
    assert not st.hung
    assert [(r.batch_decode, r.fused_decode) for r in shipped] \
        == [(batch_decode, fused_decode)]
    for ref_spec in (api.serve_spec(n_workers=1),
                     api.serve_spec(n_workers=2, threaded=True)):
        b = _reqs(Request)
        RDLBServeExecutor(model, params, spec=ref_spec).serve(b)
        for x, y in zip(a, b):
            assert x.output is not None and np.array_equal(x.output,
                                                           y.output)
    assert_no_orphans()


@pytest.mark.parametrize("batch_decode,fused_decode",
                         [(True, True), (False, True), (True, False),
                          (False, False)])
def test_serve_runner_decodes_with_its_flags(batch_decode, fused_decode,
                                             tmp_path, monkeypatch):
    """ServeTaskRunner carries the executor's two flags across the ship
    and decodes with them in the child (run here in this process):
    without ``fused_decode`` no FusedGenerator is built and every group
    goes through the per-token loop, one request a group without
    ``batch_decode``; the tokens are the executor's."""
    from repro_torch.runtime import serve_executor
    model = build_model(CFG)
    params = model.init(0, device="cpu")
    reqs = _reqs(Request)
    runner = cluster.ServeTaskRunner.from_model(
        model, params, reqs, batch_decode=batch_decode,
        fused_decode=fused_decode).ship(str(tmp_path))
    assert runner.params is None and runner.device == "cpu"
    groups = []
    loop = serve_executor.greedy_decode_group

    def spy(model, params, decode_step, prompts, max_new):
        groups.append(prompts.shape[0])
        return loop(model, params, decode_step, prompts, max_new)

    monkeypatch.setattr(serve_executor, "greedy_decode_group", spy)
    runner.setup()
    assert (runner._gen is None) == (not fused_decode)
    got = runner(list(range(len(reqs))))
    want = _reqs(Request)
    RDLBServeExecutor(model, params,
                      spec=api.serve_spec(n_workers=1)).serve(want)
    for w in want:
        np.testing.assert_array_equal(got[w.rid], w.output)
    if fused_decode:
        assert groups == []
    else:
        # six prompts of one length: one group, or six of one request
        assert groups == ([6] if batch_decode else [1] * 6)


# ------------------------------------------- against the reference's runs
@pytest.mark.parametrize("technique,kill", [("FAC", False), ("GSS", False),
                                            ("FAC", True)])
def test_partition_and_commit_log_equal_reference_cluster(technique, kill):
    """The same spec JSON through both packages' ClusterRun and Engine:
    the original-chunk partitions are equal across the four runs, and
    both process runs commit every task exactly once with the same
    results (the reference's workers are forked light runners here)."""
    P, N = 4, 96
    tt = np.full(N, 0.003)
    workers = ((api.WorkerSpec(),)
               + (api.WorkerSpec(fail_time=0.05),) * (P - 1)
               if kill else ())
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique=technique, seed=3),
        cluster=api.ClusterSpec(n_workers=P, workers=workers),
        execution=process(), n_tasks=N)
    jspec = japi.RunSpec.from_json(spec.to_json())

    tb = CountingBackend(task_fn=_square, task_times=tt)
    tst = api.run(spec, api.build(spec, tb))
    jb = JCountingBackend(task_fn=_square, task_times=tt)
    jst = japi.run(jspec, japi.build(jspec, jb))
    vspec = spec.override("execution.mode", "virtual")
    vst = api.run(vspec, api.build(vspec, simulator.SimBackend(tt)))
    jvspec = jspec.override("execution.mode", "virtual")
    jvst = japi.run(jvspec, japi.build(jvspec, jsimulator.SimBackend(tt)))

    assert not tst.hung and not jst.hung
    assert originals(tst) == originals(jst) == originals(vst) \
        == originals(jvst)
    assert tb.commits == jb.commits == {t: 1 for t in range(N)}
    assert tb.results == jb.results
    if kill:
        assert tst.survivors == jst.survivors == [0]
    assert_no_orphans()


JCFG = jconfigs.get_smoke("olmo-1b").replace(dtype="float32")


def _pair():
    jm = jbuild(JCFG)
    jp = jm.init(jax.random.PRNGKey(0))
    jp_np = jax.tree_util.tree_map(np.asarray, jp)
    tm = build_model(ModelConfig.from_reference(JCFG))
    return jm, jp, jp_np, tm, params_from_reference(tm, jp_np, device="cpu")


def _serve_spec(jax_side: bool):
    mod = japi if jax_side else api
    return (mod.serve_spec(technique="SS", n_workers=2)
            .override("execution.mode", "process")
            .override("execution.stall_timeout", 120.0)
            .override("execution.wall_timeout", 300.0))


def test_process_serving_tokens_equal_reference_process_serving():
    """Both packages serve the same requests in process mode with the
    same weights, a replica fail-stopping after one request: tokens
    equal exactly (float32, greedy)."""
    jm, jp, _, tm, tp = _pair()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, JCFG.vocab_size, size=5 + i % 3)
               .astype(np.int32) for i in range(6)]
    treqs = [Request(i, p, max_new_tokens=3) for i, p in enumerate(prompts)]
    jreqs = [JRequest(i, p, max_new_tokens=3) for i, p in enumerate(prompts)]
    tst = RDLBServeExecutor(tm, tp, spec=_serve_spec(False)).serve(
        treqs, fail_at={1: 1})
    jst = JServe(jm, jp, spec=_serve_spec(True)).serve(jreqs,
                                                      fail_at={1: 1})
    assert not tst.hung and not jst.hung
    for t, j in zip(treqs, jreqs):
        np.testing.assert_array_equal(t.output, j.output)
    assert_no_orphans()


def test_process_training_grads_equal_reference_process_training():
    """Both packages' TrainTaskRunner in process mode over the same
    batch and weights, P=2, 4 tasks, one worker fail-stopping after its
    first task: the exactly-once reduced gradients agree within 1e-5 of
    each leaf's largest magnitude."""
    from repro.cluster import TrainTaskRunner as JRunner
    from repro_torch.cluster import TrainTaskRunner
    from repro_torch.data import batch_for_step as tbatch
    from repro.data import batch_for_step as jbatch
    jm, jp, jp_np, tm, tp = _pair()
    n_tasks = 4
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="SS"),
        cluster=api.ClusterSpec(n_workers=2, workers=(
            api.WorkerSpec(), api.WorkerSpec(fail_after_tasks=1))),
        execution=process(stall_timeout=120.0, wall_timeout=300.0),
        n_tasks=n_tasks)
    jspec = japi.RunSpec.from_json(spec.to_json())
    tb = TrainBackend(lambda t: None, exact_accumulation=True)
    factory = TrainTaskRunner.from_executor(
        tm, tp, tbatch(tm.cfg, 0, 8, 16), n_tasks)
    tst = api.run(spec, api.build(spec, tb, factory=factory))
    jb = JTrainBackend(lambda t: None, exact_accumulation=True)
    jfactory = JRunner(JCFG, jp_np, jax.tree_util.tree_map(
        np.asarray, jbatch(JCFG, 0, 8, 16)), n_tasks)
    jst = japi.run(jspec, japi.build(jspec, jb, factory=jfactory))
    assert not tst.hung and not jst.hung
    assert tb.n_done == jb.n_done == n_tasks
    assert abs(tb.loss_sum - jb.loss_sum) <= 1e-5 * abs(jb.loss_sum)
    want = params_from_reference(tm, jax.tree_util.tree_map(
        np.asarray, jb.reduced()), device="cpu")
    for a, b in zip(tree_leaves(tb.reduced()), tree_leaves(want)):
        assert a.shape == b.shape
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * scale
    assert_no_orphans()


# ------------------------------------------------ what the port adds
def test_runner_start_methods():
    """A task function on the card spawns; one on the host forks; the
    executors' runners always spawn."""
    assert cluster.task_device(_square) == "cpu"
    assert cluster.task_device(None) == "cpu"
    tile = mandelbrot.compute_tile
    assert cluster.task_device(tile) == "cuda"              # None: card
    assert cluster.task_device(functools.partial(tile, device="cpu")) \
        == "cpu"
    assert cluster.task_device(functools.partial(tile, device="cuda:0")) \
        == "cuda"
    assert cluster.task_device(functools.partial(
        tile, device=torch.device("cuda"))) == "cuda"
    assert cluster.FnRunner(_square).start_method == "fork"
    assert cluster.FnRunner(functools.partial(
        tile, device="cuda")).start_method == "spawn"
    assert cluster.TrainTaskRunner.start_method == "spawn"
    assert cluster.ServeTaskRunner.start_method == "spawn"


@dataclasses.dataclass
class _CardRunner:
    """Declares the card, as the executors' runners do on a GPU."""
    start_method = "spawn"

    def __call__(self, tasks):
        return {t: t for t in tasks}


def test_card_runner_refuses_a_forked_child():
    """A runner that declares the card never runs in a forked child: the
    child raises and says why, and the master re-raises after teardown
    (nothing carries on on the CPU)."""
    from repro_torch.cluster import master, transport
    import tempfile
    import threading
    tmp = tempfile.mkdtemp(prefix="rdlb-test-")
    addr = os.path.join(tmp, "m.sock")
    lsock = transport.listen(addr)
    got = []

    def serve():
        conn = transport.Connection(lsock.accept()[0])
        got.append(conn.recv())
        got.append(conn.recv())
        conn.close()

    th = threading.Thread(target=serve)
    th.start()
    ctx = multiprocessing.get_context("fork")
    p = ctx.Process(target=master.worker_main, args=(addr, 0, _CardRunner()))
    master._start_quietly(p)
    p.join(30)
    th.join(30)
    lsock.close()
    assert got[0][0] == "hello"
    assert got[1][0] == "error" and "forked child cannot use CUDA" in got[1][2]
    assert not p.is_alive()
    assert_no_orphans()


def test_children_report_their_kernel_path():
    """Each child that ran a task reports its kernel path and launches
    to the master (per process: the master's own counts say nothing of
    its children); here Mandelbrot tiles on the CPU in forked children,
    through a SIGKILL, each tile equal to the plain version's."""
    N = 16
    fn = functools.partial(mandelbrot.compute_tile, side=128, tile=32,
                           max_iters=32, device="cpu")
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="SS"),
        cluster=api.ClusterSpec(n_workers=2, workers=(
            api.WorkerSpec(), api.WorkerSpec(fail_after_tasks=3))),
        execution=process(), n_tasks=N)
    cluster.reset_runs()
    backend = CountingBackend(task_fn=fn)
    st = api.run(spec, api.build(spec, backend))
    assert not st.hung and backend.commits == {t: 1 for t in range(N)}
    img = mandelbrot.assemble(backend.results, side=128, tile=32)
    np.testing.assert_array_equal(img, mandelbrot.escape_counts(
        128, 32, device="cpu"))
    (run,) = cluster.runs()
    assert run["payload_bytes"] > N * 32 * 32 * 4
    reports = [c["kernels"] for c in run["children"].values()
               if c["kernels"] is not None]
    assert reports and all(
        r["status"]["mandelbrot"]["path"] == "torch" and r["launches"] == {}
        for r in reports)
    starts = [c["spawn_to_first_assign_s"] for c in run["children"].values()
              if c["spawn_to_first_assign_s"] is not None]
    assert starts and min(starts) >= 0.0
    assert_no_orphans()


def test_forked_children_start_from_zero_kernel_counts():
    """A forked child inherits its parent's memory, kernel telemetry
    included: it starts from no path records and zero launch and event
    counts, so its reports hold its own Mandelbrot tiles alone, whatever
    the parent launched or counted before the fork; the parent's counts
    stay as they were."""
    from repro_torch.kernels import dispatch
    from repro_torch.runtime import serve_executor
    dispatch.count_launch("parent-launch-site")
    dispatch.count_event(serve_executor.PREFILL_HITS)
    dispatch.count_event(serve_executor.PREFILL_CAPTURES)
    before = (dispatch.launches(), dispatch.events(), dispatch.status())
    fn = functools.partial(mandelbrot.compute_tile, side=64, tile=32,
                           max_iters=16, device="cpu")
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="SS"),
        cluster=api.ClusterSpec(n_workers=2), execution=process(),
        n_tasks=4)
    cluster.reset_runs()
    backend = CountingBackend(task_fn=fn)
    st = api.run(spec, api.build(spec, backend))
    assert not st.hung and backend.commits == {t: 1 for t in range(4)}
    (run,) = cluster.runs()
    reports = [c["kernels"] for c in run["children"].values()
               if c["kernels"] is not None]
    assert reports
    for r in reports:
        assert r["launches"] == {} and r["events"] == {}
        assert r["status"] == {"mandelbrot": {"path": "torch"}}
    assert (dispatch.launches(), dispatch.events(),
            dispatch.status()) == before
    assert_no_orphans()


def test_chunk_runner_psia_exactly_once():
    """ChunkRunner computes a chunk as one batch (PSIA's spin images, one
    launch a chunk on the card); here on the CPU in forked children
    through a SIGKILL, every image equal to the direct computation."""
    from repro_torch.apps import psia
    from repro_torch.core.engine import WorkerBackend

    class Spins(WorkerBackend):
        def __init__(self):
            self.results = {}

        def commit(self, chunk, wid, payload, newly):
            for t in newly:
                self.results[t] = payload[t]

    N = 48
    fn = functools.partial(psia.compute_tasks, n=N, cloud_n=256,
                           device="cpu")
    runner = cluster.ChunkRunner(fn)
    assert runner.start_method == "fork"
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="FAC"),
        cluster=api.ClusterSpec(n_workers=3, workers=(
            api.WorkerSpec(), api.WorkerSpec(fail_after_tasks=1),
            api.WorkerSpec())),
        execution=process(), n_tasks=N)
    backend = counting_backend_of(Spins)()
    st = api.run(spec, api.build(spec, backend, factory=runner))
    assert not st.hung and backend.commits == {t: 1 for t in range(N)}
    want = fn(list(range(N)))
    np.testing.assert_array_equal(
        np.stack([backend.results[t] for t in range(N)]), want)
    assert_no_orphans()


# -------------------------------------------------- serve executor repair
def test_serve_slow_and_max_rounds_match_reference_virtual():
    """The serve executor's ``slow`` state and ``max_rounds``: virtual
    ServeStats equal the reference's with a slow replica, and a horizon
    of rounds too short to finish hangs in both."""
    jm, jp, _, tm, tp = _pair()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, JCFG.vocab_size, size=4).astype(np.int32)
               for _ in range(8)]
    for max_rounds in (None, 2):
        tex = RDLBServeExecutor(tm, tp, spec=api.serve_spec(n_workers=3))
        jex = JServe(jm, jp, spec=japi.serve_spec(n_workers=3))
        tex.slow[1] = jex.slow[1] = 2.5
        treqs = [Request(i, p, max_new_tokens=2)
                 for i, p in enumerate(prompts)]
        jreqs = [JRequest(i, p, max_new_tokens=2)
                 for i, p in enumerate(prompts)]
        tst = tex.serve(treqs, max_rounds=max_rounds)
        jst = jex.serve(jreqs, max_rounds=max_rounds)
        assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
        assert tst.hung == (max_rounds is not None)
        if not tst.hung:
            assert tst.by_worker[1] < tst.by_worker[0]
            for t, j in zip(treqs, jreqs):
                np.testing.assert_array_equal(t.output, j.output)


def test_serve_slow_in_process_mode_is_one_sleep(monkeypatch):
    """In process mode the executor carries ``slow`` as sleep_per_task
    alone (no duty cycle on top): the spec it builds has the replica at
    speed 1 with the extra seconds as its sleep."""
    seen = []
    real = api.build

    def spy(spec, backend, **kw):
        seen.append(spec)
        return real(spec, backend, **kw)

    from repro_torch.runtime import serve_executor
    monkeypatch.setattr(serve_executor.api, "build", spy)
    model = build_model(CFG)
    params = model.init(0, device="cpu")
    spec = (api.serve_spec(technique="SS", n_workers=2)
            .override("execution.mode", "process")
            .override("execution.stall_timeout", 120.0)
            .override("execution.wall_timeout", 300.0))
    ex = RDLBServeExecutor(model, params, spec=spec)
    ex.slow[1] = 0.05
    reqs = _reqs(Request, 4)
    assert not ex.serve(reqs).hung
    w = seen[0].cluster.workers[1]
    assert w.speed == 1.0 and w.sleep_per_task == pytest.approx(0.05)
    assert all(r.output is not None for r in reqs)
    vex = RDLBServeExecutor(model, params, spec=api.serve_spec(n_workers=2))
    vex.slow[1] = 0.05
    vex.serve(_reqs(Request, 4))
    assert seen[1].cluster.workers[1].speed == pytest.approx(1 / 1.05)
    assert_no_orphans()


def test_cli_runs_a_process_spec(tmp_path, capsys):
    """``python -m repro_torch run`` on a spec with ``"mode": "process"``:
    worker processes sleep the workload's nominal times, one is
    SIGKILLed, and the run line reports every task finished."""
    from repro_torch.api import cli
    spec = api.RunSpec(
        scheduling=api.SchedulingSpec(technique="FAC"),
        cluster=api.ClusterSpec(n_workers=3, workers=(
            api.WorkerSpec(), api.WorkerSpec(fail_time=0.05),
            api.WorkerSpec())),
        execution=process(), name="cli_process")
    path = tmp_path / "run.json"
    path.write_text(json.dumps({
        "workload": {"kind": "uniform", "n": 40, "t": 0.01},
        "spec": spec.to_dict()}))
    cluster.reset_runs()
    assert cli.main(["run", "--spec", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "run,cli_process,FAC" in out
    (run,) = cluster.runs()
    assert not run["hung"] and len(run["children"]) == 3
    assert [e["action"] for e in run["chaos"]] == ["kill"]
    assert_no_orphans()
