"""The port's training path (``repro_torch.optim``, ``repro_torch.data``,
``TransformerModel.loss``, ``RDLBTrainExecutor``, ``runtime.elastic``,
``launch.train``) on the CPU, against the JAX package and against its own
failure-free runs.

Weights cross by ``models.convert.params_from_reference``, and so do the
JAX gradients and optimizer moments (they have the parameters' tree).
Tolerances, each relative to the largest magnitude of the leaf compared
(float32 configs; the two frameworks sum in other orders): optimizer
updates 1e-6 (the same float32 arithmetic, reductions over other
groupings); loss 1e-5 and gradients 1e-5 (a forward and backward through
every layer).  One executor step's parameters: adamw's first step moves
each element by lr * g / (|g| + 1e-8), about lr whatever the size of g,
so a gradient near 1e-8 turns float32 rounding into a visible
difference; every element within 0.1 lr, and at most 1 in 10^4 of them
(6 of 106,816 here) more than 1e-6 apart.  Within the port, failures and
duplicates must change nothing: parameters bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import optim as joptim
from repro.configs import get_smoke as jget_smoke
from repro.data import batch_for_step as jbatch_for_step
from repro.models import build_model as jbuild
from repro.models.config import ModelConfig as JModelConfig
from repro.runtime import RDLBTrainExecutor as JExecutor
from repro_torch import api, optim
from repro_torch.configs import get_smoke
from repro_torch.data import as_tensors, batch_for_step
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.models.common import ParamTree, tree_leaves
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_reference
from repro_torch.runtime import FaultPlan, RDLBTrainExecutor
from repro_torch.runtime.elastic import rebalance_tasks, shrink_to_survivors
from repro_torch.runtime.executor import value_and_grad

# the executor tests' config (tests/test_executor.py), in float32
JCFG = JModelConfig(family="dense", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32")
CFG = ModelConfig.from_reference(JCFG)
JCONFIGS = {"gqa": JCFG,
            "olmo-smoke": jget_smoke("olmo-1b").replace(dtype="float32")}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small shapes: one intra-op thread.  With a team per process, the
    OpenMP/MKL barriers of thousands of tiny ops wait on threads that the
    other test processes have descheduled (a float64 gradcheck runs 6x
    slower on a loaded CPU with 8 threads than with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair(jcfg):
    """(reference model, its params, port model, port params)."""
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(ModelConfig.from_reference(jcfg))
    return jm, jp, tm, params_from_reference(tm, _np_tree(jp), device="cpu")


def assert_leaves_close(got, want, rel):
    """Leaf by leaf: max |got - want| <= rel * max |want|."""
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= rel * scale, (
            float((a - b).abs().max()), scale)


def trees_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


# ------------------------------------------------------------- optimizers
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_match_jax(name):
    """Three clipped updates on olmo-smoke's parameter tree (its layer
    stack unstacked in the port), fed the same random gradients."""
    jm, jp, tm, tp = pair(JCONFIGS["olmo-smoke"])
    jopt = joptim.make_optimizer(name, lr=1e-2)
    topt = optim.make_optimizer(name, lr=1e-2)
    jst, tst = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(0)
    for _ in range(3):
        jg = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape,
                                                      dtype=np.float32)), jp)
        tg = params_from_reference(tm, _np_tree(jg), device="cpu")
        jg, jnorm = joptim.clip_by_global_norm(jg, 50.0)
        tg, tnorm = optim.clip_by_global_norm(tg, 50.0)
        assert abs(float(tnorm) - float(jnorm)) <= 1e-6 * float(jnorm)
        assert_leaves_close(tg, params_from_reference(tm, _np_tree(jg),
                                                      device="cpu"), 1e-6)
        ju, jst = jopt.update(jg, jst, jp)
        tu, tst = topt.update(tg, tst, tp)
        assert_leaves_close(tu, params_from_reference(tm, _np_tree(ju),
                                                      device="cpu"), 1e-6)
        jp, tp = joptim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        assert isinstance(tp, ParamTree)
        assert_leaves_close(tp, params_from_reference(tm, _np_tree(jp),
                                                      device="cpu"), 1e-6)
    assert int(tst["step"]) == int(jst["step"]) == 3


def test_apply_updates_rounds_once_to_the_param_dtype():
    p = {"w": torch.tensor([1.0, 2.0], dtype=torch.bfloat16)}
    u = {"w": torch.tensor([2.0 ** -9, -2.0 ** -8], dtype=torch.float32)}
    want = (p["w"].float() + u["w"]).to(torch.bfloat16)
    got = optim.apply_updates(p, u)["w"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make_optimizer("sgd")


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["olmo-1b", "paligemma-3b",
                                  "whisper-tiny"])
def test_batch_for_step_equals_reference(arch):
    cfg = get_smoke(arch)
    jcfg = jget_smoke(arch)
    for step, off in ((0, 0), (7, 5)):
        got = batch_for_step(cfg, step, 6, 33, seed=3, row_offset=off)
        want = jbatch_for_step(jcfg, step, 6, 33, seed=3, row_offset=off)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype
            assert np.array_equal(got[k], np.asarray(want[k])), k
    t = as_tensors(got, "cpu")
    assert t["tokens"].dtype == torch.int64


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("key", list(JCONFIGS))
def test_loss_and_grads_match_jax_value_and_grad(key):
    jm, jp, tm, tp = pair(JCONFIGS[key])
    batch = jbatch_for_step(JCONFIGS[key], 0, 4, 32)
    (jloss, jaux), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, batch)
    tbatch = as_tensors(batch_for_step(tm.cfg, 0, 4, 32), "cpu")
    loss, metrics = tm.loss(tp, tbatch)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(metrics["aux"]) == 0.0
    assert float(metrics["xent"]) == float(loss)
    tl, tgrads = value_and_grad(lambda p, b: tm.loss(p, b)[0], tp, tbatch)
    assert float(tl) == float(loss)
    assert_leaves_close(tgrads, params_from_reference(
        tm, _np_tree(jgrads), device="cpu"), 1e-5)


def test_masked_xent_matches_jax():
    from repro.models.common import softmax_xent as jxent
    from repro_torch.models.common import softmax_xent
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11), dtype=np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        want = float(jxent(logits, labels, m))
        got = float(softmax_xent(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 None if m is None else torch.from_numpy(m)))
        assert abs(got - want) <= 1e-6 * abs(want)


def test_executor_step_matches_jax_executor():
    """One FAC step (P=4, 8 tasks, exact accumulation, adamw) of the two
    executors from the same weights and batch."""
    jm, jp, tm, tp = pair(JCFG)
    batch = jbatch_for_step(JCFG, 0, 16, 32)
    lr = 1e-3
    jex = JExecutor(jm, spec=japi.train_spec(), exact_accumulation=True,
                    lr=lr)
    tex = RDLBTrainExecutor(tm, spec=api.train_spec(),
                            exact_accumulation=True, lr=lr)
    jres = jex.train_step(jp, jex.opt.init(jp), batch)
    tres = tex.train_step(tp, tex.opt.init(tp),
                          batch_for_step(CFG, 0, 16, 32))
    assert not tres.hung and not jres.hung
    assert abs(tres.loss - jres.loss) <= 1e-5 * abs(jres.loss)
    assert tres.tasks_by_worker == jres.tasks_by_worker
    want = params_from_reference(tm, _np_tree(jres.params), device="cpu")
    diffs = [(a - b).abs() for a, b in zip(tree_leaves(tres.params),
                                           tree_leaves(want))]
    assert max(float(d.max()) for d in diffs) <= 0.1 * lr
    n = sum(d.numel() for d in diffs)
    assert sum(int((d > 1e-6).sum()) for d in diffs) <= 1e-4 * n


# ------------------------------------------- twins of tests/test_executor.py
@pytest.fixture(scope="module")
def setup():
    model = build_model(CFG)
    params = model.init(0, device="cpu")
    batch = batch_for_step(CFG, 0, 16, 32)
    return model, params, batch


def run_step(model, params, batch, *, fault=None, rdlb=True,
             technique="FAC", n_workers=4, n_tasks=8):
    ex = RDLBTrainExecutor(model, n_workers=n_workers, n_tasks=n_tasks,
                           technique=technique, rdlb_enabled=rdlb,
                           exact_accumulation=True)
    opt_state = ex.opt.init(params)
    res = ex.train_step(params, opt_state, batch, fault_plan=fault)
    return ex, res


def test_clean_step_updates_params(setup):
    model, params, batch = setup
    _, res = run_step(model, params, batch)
    assert not res.hung and np.isfinite(res.loss)
    assert not trees_equal(params, res.params)


@pytest.mark.parametrize("technique", ["SS", "FAC", "GSS", "AWF-B", "AF"])
def test_grads_identical_under_failures(setup, technique):
    """The paper property at gradient level: k fail-stop workers change
    nothing about the computed update."""
    model, params, batch = setup
    _, clean = run_step(model, params, batch, technique=technique)
    _, faulty = run_step(model, params, batch, technique=technique,
                         fault=FaultPlan(fail_after={1: 1, 3: 0}))
    assert not faulty.hung
    assert faulty.n_duplicates >= 1
    assert trees_equal(clean.params, faulty.params)
    assert clean.loss == pytest.approx(faulty.loss, abs=1e-9)


def test_w_minus_1_failures_tolerated(setup):
    model, params, batch = setup
    _, clean = run_step(model, params, batch)
    _, res = run_step(model, params, batch,
                      fault=FaultPlan(fail_after={1: 0, 2: 0, 3: 0}))
    assert not res.hung and len(res.survivors) == 1
    assert trees_equal(clean.params, res.params)


def test_hang_without_rdlb(setup):
    model, params, batch = setup
    _, res = run_step(model, params, batch, rdlb=False,
                      fault=FaultPlan(fail_after={1: 1}))
    assert res.hung and res.params is params


def test_no_failure_no_rdlb_is_fine(setup):
    model, params, batch = setup
    _, a = run_step(model, params, batch, rdlb=False)
    _, b = run_step(model, params, batch, rdlb=True)
    assert not a.hung and trees_equal(a.params, b.params)


def test_straggler_gets_duplicated(setup):
    model, params, batch = setup
    _, clean = run_step(model, params, batch)
    ex = RDLBTrainExecutor(model, n_workers=4, n_tasks=8, technique="SS",
                           exact_accumulation=True)
    res = ex.train_step(params, ex.opt.init(params), batch,
                        fault_plan=FaultPlan(slow={0: 0.05}))
    assert not res.hung
    assert trees_equal(clean.params, res.params)


def test_elastic_shrink_and_rebalance(setup):
    model, params, batch = setup
    ex, res = run_step(model, params, batch,
                       fault=FaultPlan(fail_after={2: 0}))
    st = shrink_to_survivors(ex)
    assert ex.n_workers == 3 and st.generation == 1
    n = rebalance_tasks(8, ex.n_workers, 16)
    assert 16 % n == 0 and n >= ex.n_workers


def test_rebalance_terminates_when_workers_exceed_batch():
    assert rebalance_tasks(8, 12, 8) == 8
    assert rebalance_tasks(16, 12, 8) == 8
    assert rebalance_tasks(8, 3, 16) == 8
    assert rebalance_tasks(5, 2, 16) == 8
    assert rebalance_tasks(1, 1, 7) == 1
    with pytest.raises(ValueError):
        rebalance_tasks(4, 4, 0)


def test_shrink_carries_survivor_state(setup):
    model, params, batch = setup
    ex = RDLBTrainExecutor(model, n_workers=4, n_tasks=8, technique="FAC",
                           exact_accumulation=True)
    res = ex.train_step(params, ex.opt.init(params), batch,
                        fault_plan=FaultPlan(fail_after={2: 0},
                                             slow={0: 0.5}))
    assert not res.hung
    before = {w.wid: (w.speed, w.tasks_done)
              for w in ex.workers if w.alive}
    st = shrink_to_survivors(ex)
    assert ex.n_workers == 3 and st.generation == 1
    renumbering = st.history[-1]["renumbering"]
    assert set(renumbering) == set(before)
    for old_wid, new_wid in renumbering.items():
        w = ex.workers[new_wid]
        assert w.wid == new_wid and w.alive
        assert (w.speed, w.tasks_done) == before[old_wid]
    assert any(w.tasks_done > 0 for w in ex.workers)
    assert any(w.speed == 0.5 for w in ex.workers)


def test_wasted_work_accounting(setup):
    model, params, batch = setup
    ex = RDLBTrainExecutor(model, n_workers=4, n_tasks=4, technique="SS",
                           exact_accumulation=True)
    res = ex.train_step(params, ex.opt.init(params), batch,
                        fault_plan=FaultPlan(slow={0: 0.01}))
    assert sum(res.tasks_by_worker.values()) >= res.n_tasks


def test_threaded_fail_stop_is_bit_identical(setup):
    """Real threads racing duplicates, with arrival-order accumulation
    off: two steps under a fail-stop equal the failure-free steps."""
    model, params, batch = setup
    runs = []
    for fail in (None, {1: 1}):
        spec = api.train_spec(n_workers=4, n_tasks=8, threaded=True)
        ex = RDLBTrainExecutor(model, spec=spec, exact_accumulation=True)
        p, st, dups = params, ex.opt.init(params), 0
        for step in range(2):
            if fail and step == 0:
                for w, n in fail.items():
                    ex.workers[w].fail_after_tasks = n
            res = ex.train_step(p, st, batch_for_step(CFG, step, 16, 32))
            assert not res.hung
            p, st, dups = res.params, res.opt_state, dups + res.n_duplicates
        runs.append((p, dups))
    assert runs[1][1] >= 1
    assert trees_equal(runs[0][0], runs[1][0])


def test_spec_and_process_mode():
    model = build_model(CFG)
    with pytest.raises(TypeError, match="spec= OR legacy"):
        RDLBTrainExecutor(model, spec=api.train_spec(), n_workers=2)
    with pytest.raises(ValueError, match="n_tasks"):
        RDLBTrainExecutor(model, spec=api.train_spec().replace(n_tasks=None))
    spec = api.train_spec().override("execution.mode", "process")
    ex = RDLBTrainExecutor(model, spec=spec)
    params = model.init(0, device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        ex.train_step(params, ex.opt.init(params),
                      batch_for_step(CFG, 0, 8, 8))


# --------------------------------------------------------------- launcher
def test_train_cli_survives_a_fail_stop(capsys, tmp_path):
    losses = ttrain.main(["--arch", "olmo-1b", "--smoke", "--steps", "3",
                          "--global-batch", "8", "--seq-len", "16",
                          "--fail", "1:1,2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "injecting fail-stop of workers [1, 2]" in out
    assert "workers=2" in out
    with pytest.raises(SystemExit, match="no checkpoint"):
        ttrain.main(["--arch", "olmo-1b", "--smoke", "--steps", "2",
                     "--global-batch", "8", "--seq-len", "16", "--no-rdlb",
                     "--fail", "0:1", "--device", "cpu"])
    # checkpoints are taken: --ckpt-dir and --ckpt-interval are accepted
    losses = ttrain.main(["--smoke", "--steps", "2", "--global-batch", "8",
                          "--seq-len", "16", "--ckpt-dir",
                          str(tmp_path / "ck"), "--ckpt-interval", "1",
                          "--device", "cpu"])
    assert len(losses) == 2
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000001", "step_00000002"]
