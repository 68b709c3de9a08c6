"""rwkv6 training in the port on the CPU: the gradient of ``wkv6_batched``
(``WKV6BatchedFn``, ``wkv6_batched_backward``), ``RWKV6Model.loss``, the
training executor over it, and the rematerialisation policies
(``models.common.remat``), against the JAX package and against the port's
own plain versions.

Weights cross by ``models.convert.params_from_reference``; inputs come
from numpy seeds.  Tolerances, each relative to the largest magnitude of
the gradient compared (float32):

* ``WKV6BatchedFn`` against ``jax.grad`` of the reference's
  ``wkv6_chunked`` and ``wkv6_sequential``, against autograd through the
  port's ``wkv6_sequential`` under strong decay and against autograd
  through ``wkv6_batched_plain``: 1e-5 (bfloat16 inputs: 2**-6, each
  side rounds its float32 gradient to 8 significant bits once);
* ``RWKV6Model.loss`` against ``jax.value_and_grad`` of the reference on
  rwkv6-smoke: loss 1e-5, gradients 3e-5.  At the initial weights the
  time-first bonus u is 0 and the state starts at 0, so every head's
  first output is exactly 0 and the per-head group norm's backward
  multiplies the two frameworks' float32 rounding by 1 / sqrt(eps)
  (about 316): autograd through the plain version differs from JAX by
  1.2e-5 as well, so the excess is not the backward's;
* one executor step: the bound of olmo's test in
  ``tests/test_torch_train.py``.  Within the port, failures,
  duplicates and rematerialisation change nothing: bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import get_smoke as jget_smoke
from repro.data import batch_for_step as jbatch_for_step
from repro.models import build_model as jbuild
from repro.models import rwkv6 as jrwkv6
from repro.runtime import RDLBTrainExecutor as JExecutor
from repro_torch import api
from repro_torch.configs import get_smoke
from repro_torch.data import as_tensors, batch_for_step
from repro_torch.kernels import dispatch, ops
from repro_torch.kernels import rwkv6_scan as kw
from repro_torch.models import build_model
from repro_torch.models import common
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.models.common import remat, tree_leaves
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_reference
from repro_torch.runtime import RDLBTrainExecutor
from repro_torch.runtime.executor import value_and_grad

JCFG = jget_smoke("rwkv6-1.6b").replace(dtype="float32")
CFG = ModelConfig.from_reference(JCFG)
BF16_TOL = 2.0 ** -6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small shapes: one intra-op thread (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wkv_inputs(seed, BH, T, dk, dv, *, w_lo=0.05, w=None):
    """r, k, v, w, u, state and the output gradients dy, dstate as
    float32 numpy arrays; w uniform in [w_lo, 0.99], or the constant w."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    ww = (rng.uniform(w_lo, 0.99, (BH, T, dk)).astype(np.float32)
          if w is None else np.full((BH, T, dk), w, np.float32))
    ins = [f(BH, T, dk), f(BH, T, dk), f(BH, T, dv), ww, f(BH, dk),
           f(BH, dk, dv)]
    return ins, f(BH, T, dv), f(BH, dk, dv)


def fn_grads(ins, dy, dstate, *, dtype=torch.float32):
    """Gradients of sum(y dy) + sum(S dstate) through WKV6BatchedFn."""
    leaves = [torch.from_numpy(x).to(dtype) for x in ins[:5]]
    leaves.append(torch.from_numpy(ins[5]))
    leaves = [t.requires_grad_() for t in leaves]
    y, s = kw.wkv6_batched_train(*leaves)
    obj = (y * torch.from_numpy(dy)).sum() + (s * torch.from_numpy(dstate)
                                              ).sum()
    return torch.autograd.grad(obj, leaves)


def autograd_grads(fn, ins, dy, dstate, *, dtype=torch.float32):
    """The same gradients by autograd through ``fn`` (batched r, k, v, w,
    u, state -> (y, S))."""
    leaves = [torch.from_numpy(x).to(dtype) for x in ins[:5]]
    leaves.append(torch.from_numpy(ins[5]))
    leaves = [t.requires_grad_() for t in leaves]
    y, s = fn(*leaves)
    obj = (y.float() * torch.from_numpy(dy)).sum() + (
        s * torch.from_numpy(dstate)).sum()
    return torch.autograd.grad(obj, leaves)


def assert_rel_close(got, want, rel):
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w, np.float32)) if not isinstance(
            w, torch.Tensor) else w.float()
        err = float((g.float() - w).abs().max() / w.abs().max().clamp(
            min=1e-30))
        assert err <= rel, (err, rel)


def per_head(fn):
    """A single-head (T, d) function of the port over the BH rows."""
    def batched(r, k, v, w, u, s):
        ys, ss = zip(*(fn(r[b], k[b], v[b], w[b], u[b], s[b])
                       for b in range(r.shape[0])))
        return torch.stack(ys), torch.stack(ss)
    return batched


# --------------------------------------------------------- WKV6BatchedFn
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("T,form", [(64, "wkv6_chunked"),
                                    (37, "wkv6_sequential")])
def test_grads_match_jax_grad_of_reference(T, form, seed):
    """Moderate decay (w in [0.5, 0.99]), a nonzero input state: every
    gradient, the state's included, against jax.grad of the reference's
    form that its model takes at this T."""
    ins, dy, ds = wkv_inputs(seed, 3, T, 16, 16, w_lo=0.5)
    jfn = getattr(jrwkv6, form)

    def obj(*a):
        y, s = jax.vmap(jfn)(*a)
        return (y * dy).sum() + (s * ds).sum()

    want = jax.grad(obj, argnums=tuple(range(6)))(*ins)
    got = fn_grads(ins, dy, ds)
    assert_rel_close(got, want, 1e-5)


@pytest.mark.parametrize("T", [64, 37])
def test_strong_decay_grads_match_sequential_autograd(T):
    """w = 0.01, where the reference's chunked form overflows: against
    autograd through the port's one-step-at-a-time ``wkv6_sequential``."""
    ins, dy, ds = wkv_inputs(2, 3, T, 16, 16, w=0.01)
    want = autograd_grads(per_head(trwkv6.wkv6_sequential), ins, dy, ds)
    assert_rel_close(fn_grads(ins, dy, ds), want, 1e-5)


@pytest.mark.parametrize("T", [1, 31, 32, 33, 100])
def test_grads_match_autograd_of_plain(T):
    """Ragged and whole chunks, w in [0.05, 0.99].  (Under strong decay,
    autograd through the plain version is itself 1.6e-5 off a float64
    sequential recurrence: its log-decay gradients add a term at one end
    of a range and take it off at the other; the test above covers that
    case.)"""
    ins, dy, ds = wkv_inputs(T, 2, T, 16, 8)
    want = autograd_grads(kw.wkv6_batched_plain, ins, dy, ds)
    assert_rel_close(fn_grads(ins, dy, ds), want, 1e-5)


def test_bf16_grads_in_input_dtypes():
    """bfloat16 r, k, v, w, u: gradients come back in bfloat16, the
    state's in float32, each within one bfloat16 rounding."""
    ins, dy, ds = wkv_inputs(5, 2, 70, 16, 16)
    got = fn_grads(ins, dy, ds, dtype=torch.bfloat16)
    want = autograd_grads(kw.wkv6_batched_plain, ins, dy, ds,
                          dtype=torch.bfloat16)
    assert [g.dtype for g in got] == [torch.bfloat16] * 5 + [torch.float32]
    assert_rel_close(got, want, BF16_TOL)


def test_one_output_only_and_state_untouched():
    """A loss of y alone, or of the final state alone; a state that needs
    no gradient gets None; the forward never writes its input state."""
    ins, dy, ds = wkv_inputs(7, 2, 45, 8, 8)
    leaves = [torch.from_numpy(x).requires_grad_() for x in ins[:5]]
    state = torch.from_numpy(ins[5])
    before = state.clone()
    y, s = ops.wkv6_batched_train(*leaves, state)
    assert torch.equal(state, before)
    py, ps = kw.wkv6_batched_plain(*leaves, state)
    assert torch.equal(y, py) and torch.equal(s, ps)
    for got, want in (((y, dy), (py, dy)), ((s, ds), (ps, ds))):
        g = torch.autograd.grad((got[0] * torch.from_numpy(got[1])).sum(),
                                leaves, retain_graph=True)
        w = torch.autograd.grad((want[0] * torch.from_numpy(want[1])).sum(),
                                leaves, retain_graph=True,
                                materialize_grads=True)
        assert_rel_close(g, w, 1e-5)
    grads = y.grad_fn.apply(torch.from_numpy(dy), None)
    assert grads[5] is None and all(g is not None for g in grads[:5])


def test_groups_of_chunks_change_nothing(monkeypatch):
    """The pairwise decays formed a few chunks at a time give the bits of
    forming them all at once."""
    ins, dy, ds = wkv_inputs(8, 4, 200, 16, 16)
    t = [torch.from_numpy(x) for x in ins] + [torch.from_numpy(dy),
                                              torch.from_numpy(ds)]
    whole = kw.wkv6_batched_backward(*t)
    monkeypatch.setattr(kw, "BWD_PAIR_ELEMS", 4 * 32 * 32 * 16 * 2)
    grouped = kw.wkv6_batched_backward(*t)
    assert all(torch.equal(a, b) for a, b in zip(whole, grouped))


# ------------------------------------------------------------------- model
def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    jm = jbuild(JCFG)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(CFG)
    return jm, jp, tm, params_from_reference(tm, _np_tree(jp), device="cpu")


def assert_leaves_close(got, want, rel):
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float((a - b).abs().max()) <= rel * float(b.abs().max())


@pytest.mark.parametrize("S", [64, 37])
def test_loss_and_grads_match_jax_value_and_grad(pair, S):
    jm, jp, tm, tp = pair
    batch = jbatch_for_step(JCFG, 0, 2, S)
    (jloss, jaux), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, batch)
    tbatch = as_tensors(batch_for_step(CFG, 0, 2, S), "cpu")
    loss, aux = tm.loss(tp, tbatch)
    assert aux == {} and jaux == {}
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    tl, tgrads = value_and_grad(lambda p, b: tm.loss(p, b)[0], tp, tbatch)
    assert float(tl) == float(loss)
    assert dispatch.status("wkv6_batched")["path"] == "torch"
    assert_leaves_close(tgrads, params_from_reference(
        tm, _np_tree(jgrads), device="cpu"), 3e-5)


def test_training_forward_leaves_serving_alone(pair):
    """The training forward's logits equal the serving forward's from a
    fresh state, and serving still writes its state in place."""
    _, _, tm, tp = pair
    tokens = as_tensors(batch_for_step(CFG, 1, 2, 40), "cpu")["tokens"]
    with torch.no_grad():
        train_logits = tm._train_forward(tp, tokens)
        state = tm.init_state(2, device="cpu")
        wkv = state["wkv"]
        serve_logits, out = tm.forward(tp, tokens, state)
    assert out is state and state["wkv"] is wkv and wkv.abs().sum() > 0
    torch.testing.assert_close(train_logits, serve_logits, rtol=0,
                               atol=1e-5)


def test_executor_step_matches_jax_executor(pair):
    """One FAC step (P=4, 8 tasks, exact accumulation, adamw) of the two
    executors from the same weights and batch, with the bound of olmo's
    test in tests/test_torch_train.py."""
    jm, jp, tm, tp = pair
    batch = jbatch_for_step(JCFG, 0, 8, 64)
    lr = 1e-3
    jex = JExecutor(jm, spec=japi.train_spec(), exact_accumulation=True,
                    lr=lr)
    tex = RDLBTrainExecutor(tm, spec=api.train_spec(),
                            exact_accumulation=True, lr=lr)
    jres = jex.train_step(jp, jex.opt.init(jp), batch)
    tres = tex.train_step(tp, tex.opt.init(tp),
                          batch_for_step(CFG, 0, 8, 64))
    assert not tres.hung and not jres.hung
    assert abs(tres.loss - jres.loss) <= 1e-5 * abs(jres.loss)
    assert tres.tasks_by_worker == jres.tasks_by_worker
    want = params_from_reference(tm, _np_tree(jres.params), device="cpu")
    diffs = [(a - b).abs() for a, b in zip(tree_leaves(tres.params),
                                           tree_leaves(want))]
    assert max(float(d.max()) for d in diffs) <= 0.1 * lr
    n = sum(d.numel() for d in diffs)
    assert sum(int((d > 1e-6).sum()) for d in diffs) <= 1e-4 * n


def test_threaded_fail_stop_is_bit_identical():
    """Two threaded rDLB steps of rwkv6-smoke (bfloat16, its own dtype)
    with worker 1 fail-stopping in step 0 equal the failure-free steps
    bit for bit."""
    cfg = get_smoke("rwkv6-1.6b")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    runs = []
    for fail in (False, True):
        spec = api.train_spec(n_workers=4, n_tasks=8, threaded=True)
        ex = RDLBTrainExecutor(model, spec=spec, exact_accumulation=True)
        p, st, dups = params, ex.opt.init(params), 0
        for step in range(2):
            if fail and step == 0:
                ex.workers[1].fail_after_tasks = 1
            res = ex.train_step(p, st, batch_for_step(cfg, step, 8, 40))
            assert not res.hung
            p, st, dups = res.params, res.opt_state, dups + res.n_duplicates
        runs.append((p, dups))
    assert runs[1][1] >= 1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(runs[0][0]),
                                                  tree_leaves(runs[1][0])))


# ------------------------------------------------------------------- remat
def saved_bytes_and_grads(model, params, batch):
    """Bytes of the tensors autograd saves for the backward (counted by
    ``saved_tensors_hooks``; rematerialised layers save theirs inside the
    checkpoint, out of reach) and the gradients."""
    count = [0]

    def pack(t):
        count[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        _, grads = value_and_grad(lambda p, b: model.loss(p, b)[0], params,
                                  batch)
    return count[0], grads


@pytest.mark.parametrize("policy", list(common.REMAT_POLICIES))
def test_transformer_remat_policies_change_memory_not_values(policy):
    """olmo-smoke (float32) under each policy: gradients bit for bit
    those of everything_saveable; nothing_saveable saves fewer bytes."""
    cfg = get_smoke("olmo-1b").replace(dtype="float32")
    params = build_model(cfg).init(0, device="cpu")
    batch = as_tensors(batch_for_step(cfg, 0, 2, 24), "cpu")
    full_bytes, full = saved_bytes_and_grads(
        build_model(cfg.replace(remat_policy="everything_saveable")),
        params, batch)
    n_bytes, grads = saved_bytes_and_grads(
        build_model(cfg.replace(remat_policy=policy)), params, batch)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                                  tree_leaves(full)))
    if policy == "nothing_saveable":
        assert n_bytes < full_bytes / 2, (n_bytes, full_bytes)


def test_rwkv6_layers_are_rematerialised(monkeypatch, pair):
    """rwkv6's training forward is always under nothing_saveable: the same
    gradients bit for bit as without rematerialisation, fewer bytes
    saved, and the recomputation runs the recurrence again."""
    _, _, tm, tp = pair
    batch = as_tensors(batch_for_step(CFG, 0, 2, 40), "cpu")
    calls = []
    real = kw.WKV6BatchedFn.forward

    def counted(ctx, *a):
        calls.append(1)
        return real(ctx, *a)

    monkeypatch.setattr(kw.WKV6BatchedFn, "forward", staticmethod(counted))
    n_bytes, grads = saved_bytes_and_grads(tm, tp, batch)
    assert len(calls) == 2 * CFG.n_layers            # forward + recompute
    monkeypatch.setattr(trwkv6, "remat", lambda fn, policy: fn)
    full_bytes, full = saved_bytes_and_grads(tm, tp, batch)
    assert len(calls) == 3 * CFG.n_layers
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                                  tree_leaves(full)))
    assert n_bytes < full_bytes / 2, (n_bytes, full_bytes)


def test_remat_adds_nothing_without_grad_and_rejects_unknown(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("checkpointed without grad")

    monkeypatch.setattr(common, "checkpoint", boom)
    x = torch.randn(3, 4)
    for policy in common.REMAT_POLICIES:
        with torch.no_grad():
            assert torch.equal(remat(torch.sin, policy)(x), torch.sin(x))
    with pytest.raises(KeyError):
        remat(torch.sin, "offload_everything")
