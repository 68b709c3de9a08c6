"""The port's other model families (MoE + MLA, multi-token prediction,
the Hymba hybrid, the Whisper encoder-decoder and the PaliGemma prefix-LM)
against the JAX package on the CPU, whole models: forward logits, loss
and gradients, prefill and a decode loop, FusedGenerator tokens.  The
parameters are drawn with numpy (``np_params``) and carried across by
``params_from_reference``; both sides get the same numpy inputs.  Their
parts (routing, flash_attend, the selective scan, threaded serving):
tests/test_torch_families_parts.py.

Tolerances, each with its reason (float32 configs; the two frameworks sum
matrix products, softmaxes and the selective scan in other orders, so they
agree to float32 rounding and not bit for bit):
  * logits, prefill and decode: 1e-4 absolute + 1e-5 relative, as in
    tests/test_torch_models.py;
  * loss, aux and MTP losses: 1e-5 relative;
  * gradients: 1e-5 of each leaf's largest magnitude, as in
    tests/test_torch_train.py, plus 1e-8 absolute: a router's gradient
    (about 1e-4) reaches it only through the renormalised gates, whose
    sum's gradient cancels to float32 noise of a few 1e-9; deepseek-v3
    (5 layers of MLA, 3 of them MoE, and the MTP block) within 5e-5: the
    gap grows with depth toward the input (about 9e-6 at 3 layers and
    2e-5 at 5, with or without MTP, q-lora or drops), as rounding does;
  * routing and dispatch: exact (integer indices, 0/1 tensors, gates
    within 1e-6);
  * greedy tokens (FusedGenerator, threaded serving): equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import build_model as jbuild
from repro.runtime.serve_executor import FusedGenerator as JFused
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_reference
from repro_torch.runtime.executor import value_and_grad
from repro_torch.runtime.serve_executor import FusedGenerator

# the reference donates its caches, which the CPU cannot use
pytestmark = pytest.mark.filterwarnings("ignore:Some donated buffers")

JCONFIGS = {
    "deepseek-v2-lite": jget_smoke("deepseek-v2-lite-16b").replace(
        dtype="float32"),
    "deepseek-v3": jget_smoke("deepseek-v3-671b").replace(dtype="float32"),
    "hymba": jget_smoke("hymba-1.5b").replace(dtype="float32"),
    "whisper": jget_smoke("whisper-tiny").replace(dtype="float32"),
    "paligemma": jget_smoke("paligemma-3b").replace(dtype="float32"),
}
GRAD_TOL = {"deepseek-v3": 5e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small shapes: one intra-op thread (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def np_params(specs, seed: int = 0):
    """A numpy parameter tree for the reference's ``specs``, drawn with
    numpy from ``seed`` with each spec's init (zeros, ones, or a normal
    of the spec's std), in the spec's dtype."""
    from repro.models.common import ParamSpec as JSpec
    rng = np.random.default_rng(seed)

    def draw(s):
        if s.init in ("zeros", "ones"):
            a = (np.zeros if s.init == "zeros" else np.ones)(s.shape)
        else:
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = (1.0 if s.init == "embed"
                   else s.init_scale / np.sqrt(max(1, fan_in)))
            a = std * rng.standard_normal(s.shape)
        return a.astype(jnp.dtype(s.dtype))
    return jax.tree_util.tree_map(draw, specs,
                                  is_leaf=lambda x: isinstance(x, JSpec))


_PAIRS: dict = {}


def pair(key):
    """(reference model, its params, port model, port params), built
    once per config; the parameters drawn with numpy (``np_params``)."""
    if key not in _PAIRS:
        jcfg = JCONFIGS[key]
        jm = jbuild(jcfg)
        jp = np_params(jm.param_specs())
        tm = build_model(ModelConfig.from_reference(jcfg))
        tp = params_from_reference(tm, jp, device="cpu")
        _PAIRS[key] = (jm, jp, tm, tp)
    return _PAIRS[key]


def _close(got: torch.Tensor, want, atol=1e-4, rtol=1e-5) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def inputs(key, B=2, S=16, seed=1) -> dict:
    """tokens, labels and the family's frontend stub, as numpy."""
    cfg = JCONFIGS[key]
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.n_patch_tokens, cfg.d_model), dtype=np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return out


def as_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def forward_logits(model, params, batch):
    """The family's forward -> (logits, aux or None)."""
    fam = model.cfg.family
    if fam == "encdec":
        return model.forward(params, batch["tokens"], batch["frames"]), None
    if fam == "hybrid":
        return model.forward(params, batch["tokens"]), None
    logits, aux, _ = model.forward(params, batch["tokens"],
                                   batch.get("patches"))
    return logits, aux


# ------------------------------------------------------------ forward
@pytest.mark.parametrize("key", list(JCONFIGS))
def test_forward_logits_match_jax(key):
    jm, jp, tm, tp = pair(key)
    batch = inputs(key)
    jl, jaux = jax.jit(lambda p, b: forward_logits(jm, p, b))(jp, batch)
    with torch.no_grad():
        tl, taux = forward_logits(tm, tp, as_torch(batch))
    assert tl.shape == (2, 16, JCONFIGS[key].vocab_size)
    _close(tl, jl)
    if jaux is not None:
        assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux))


@pytest.mark.parametrize("key", list(JCONFIGS))
def test_loss_and_grads_match_jax_value_and_grad(key):
    """Loss (with the routers' aux and deepseek-v3's MTP loss) and every
    gradient leaf against ``jax.value_and_grad``."""
    jm, jp, tm, tp = pair(key)
    batch = inputs(key, seed=2)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, batch)
    tbatch = as_torch(batch)
    with torch.no_grad():
        loss, metrics = tm.loss(tp, tbatch)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert sorted(metrics) == sorted(jmetrics)
    for name in metrics:
        want = float(jmetrics[name])
        assert abs(float(metrics[name]) - want) <= 1e-5 * abs(want), name
    if JCONFIGS[key].moe:
        assert float(metrics["aux"]) > 0.0
    tl, tgrads = value_and_grad(lambda p, b: tm.loss(p, b)[0], tp, tbatch)
    assert float(tl) == float(loss)
    want = params_from_reference(tm, _np_tree(jgrads), device="cpu")
    rel = GRAD_TOL.get(key, 1e-5)
    for (path, a), b in zip(_named(tgrads), tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= rel * scale + 1e-8, (
            path, float((a - b).abs().max()), scale)


def _named(tree, prefix=""):
    from repro_torch.models.common import tree_named_leaves
    return list(tree_named_leaves(tree, prefix).items())


# ------------------------------------------------------------- decode
@pytest.mark.parametrize("key", list(JCONFIGS))
def test_prefill_and_decode_loop_match_jax(key):
    """prefill over a 21-token prompt (past hymba's 16-slot window), then
    5 decode steps fed the reference's greedy tokens; whisper, which has
    no prefill, computes its cross K/V and decodes the prompt token by
    token."""
    jm, jp, tm, tp = pair(key)
    B, S, steps = 2, 21, 5
    batch = inputs(key, B=B, S=S, seed=3)
    prompts = batch["tokens"]
    jcache = jm.init_cache(B, S + steps)
    tcache = tm.init_cache(B, S + steps, device="cpu")
    jdecode = jax.jit(jm.decode_step)
    with torch.inference_mode():
        if JCONFIGS[key].family == "encdec":
            jcache = jm.prefill_cross(jp, jcache, batch["frames"])
            tcache = tm.prefill_cross(tp, tcache,
                                      torch.from_numpy(batch["frames"]))
            for pos in range(S):
                tok = prompts[:, pos:pos + 1]
                jl, jcache = jdecode(jp, jcache, tok, pos)
                tl, tcache = tm.decode_step(tp, tcache,
                                            torch.from_numpy(tok), pos)
                _close(tl, jl)
        else:
            jl, jcache = jax.jit(jm.prefill)(jp, jcache, prompts)
            tl, tcache = tm.prefill(tp, tcache, torch.from_numpy(prompts))
            assert tl.shape == (B, 1, JCONFIGS[key].vocab_size)
            _close(tl, jl)
        for pos in range(S, S + steps):
            tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
            jl, jcache = jdecode(jp, jcache, tok, pos)
            tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok),
                                        pos)
            _close(tl, jl)


@pytest.mark.parametrize("key", ["deepseek-v2-lite", "hymba", "paligemma"])
def test_prefill_cache_equals_the_decode_loops(key):
    """The cache a prefill fills equals the one the per-token decode loop
    writes (MLA's c_kv / k_rope, hymba's rolling and global K/V, SSM state
    and conv tail; the vlm patch slots stay unwritten)."""
    _, _, tm, tp = pair(key)
    # dropless capacity: prefill groups the whole prompt, decode one
    # token, so drops would legitimately differ (tests/test_models_smoke.py)
    tm = build_model(tm.cfg.replace(capacity_factor=8.0))
    S = 21
    prompts = torch.from_numpy(inputs(key, B=2, S=S, seed=4)["tokens"])
    with torch.inference_mode():
        a, ca = tm.prefill(tp, tm.init_cache(2, S + 2, device="cpu"),
                           prompts)
        cb = tm.init_cache(2, S + 2, device="cpu")
        for pos in range(S):
            b, cb = tm.decode_step(tp, cb, prompts[:, pos:pos + 1], pos)
    _close(a, b, atol=1e-5, rtol=1e-5)
    for (path, x), (_, y) in zip(_named(ca), _named(cb)):
        if x.dtype in (torch.int32, torch.int64):
            assert torch.equal(x, y), path
        else:
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=path)


@pytest.mark.parametrize("key", list(JCONFIGS))
def test_fused_generator_tokens_match_jax(key):
    """FusedGenerator's greedy tokens equal the reference's (whisper
    walks its prompt through decode_step in both)."""
    jm, jp, tm, tp = pair(key)
    prompts = inputs(key, B=3, S=11, seed=5)["tokens"]
    want = JFused(jm)(jp, prompts, 6)
    got = FusedGenerator(tm)(tp, prompts, 6)
    np.testing.assert_array_equal(got, want)
