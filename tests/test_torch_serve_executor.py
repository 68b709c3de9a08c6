"""The port's ``RDLBServeExecutor`` beyond the spec path: the per-request
(``batch_decode=False``) and per-token (``fused_decode=False``)
baselines, concurrent serving, ``fail_worker`` and the legacy keywords,
on the CPU.  Twins of the reference's
``tests/test_engine.py::test_batched_decode_matches_per_request``,
``::test_concurrent_serve_first_completion_wins``,
``::test_concurrent_serve_hang_without_rdlb`` and
``tests/test_decode_fused.py::test_executor_fused_matches_loop``, each
also holding the port's tokens equal to the JAX executor's on the same
numpy-drawn weights (``models.convert.params_from_reference``).

Tolerance: none.  Greedy tokens are compared exactly, on float32
configs (the reference's own twins run in bfloat16, where argmax ties
may flip between the two frameworks).
"""

import threading
import warnings

import jax
import numpy as np
import pytest

from repro import api as japi
from repro.models import build_model as jbuild
from repro.models.config import ModelConfig as JModelConfig
from repro.runtime import RDLBServeExecutor as JRDLBServeExecutor
from repro.runtime import Request as JRequest
from repro_torch import api
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_reference
from repro_torch.runtime import RDLBServeExecutor, Request

# the reference donates its caches, which the CPU cannot use
pytestmark = pytest.mark.filterwarnings("ignore:Some donated buffers")

# tests/test_engine.py's CFG, and tests/test_decode_fused.py's "dense",
# in float32
ENGINE_CFG = JModelConfig(family="dense", n_layers=2, d_model=64, n_heads=4,
                          n_kv_heads=2, d_ff=128, vocab_size=128,
                          dtype="float32")
FUSED_CFG = JModelConfig(family="dense", n_layers=2, d_model=64, n_heads=2,
                         n_kv_heads=2, d_ff=128, vocab_size=128,
                         dtype="float32")
LEGACY = dict(n_workers=3, technique="GSS", rdlb_enabled=False,
              max_duplicates=2, concurrent=True)


def pair(jcfg):
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(ModelConfig.from_reference(jcfg))
    tp = params_from_reference(tm, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def serve_setup():
    """tests/test_engine.py's ``serve_setup`` for both packages, and the
    JAX executor's tokens for its prompts (3 new tokens each)."""
    jm, jp, tm, tp = pair(ENGINE_CFG)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, ENGINE_CFG.vocab_size, size=6)
               .astype(np.int32) for _ in range(10)]
    jreqs = make_requests(prompts, JRequest)
    JRDLBServeExecutor(jm, jp, spec=japi.serve_spec()).serve(jreqs)
    return tm, tp, prompts, [r.output for r in jreqs]


def make_requests(prompts, cls=Request):
    return [cls(i, p, max_new_tokens=3) for i, p in enumerate(prompts)]


def assert_tokens(reqs, want):
    for r, w in zip(reqs, want):
        assert r.output is not None
        np.testing.assert_array_equal(r.output, w)


# -------------------------------------------------- the reference's twins
def test_batched_decode_matches_per_request(serve_setup):
    """One padded batch call per chunk == the per-request path, token for
    token, and both equal the JAX executor's tokens."""
    model, params, prompts, want = serve_setup
    a = make_requests(prompts)
    b = make_requests(prompts)
    # GSS -> multi-request chunks -> real batching (and batch-dim padding)
    RDLBServeExecutor(model, params, n_workers=2, technique="GSS",
                      batch_decode=True).serve(a)
    RDLBServeExecutor(model, params, n_workers=2, technique="GSS",
                      batch_decode=False).serve(b)
    for x, y in zip(a, b):
        assert x.output is not None and np.array_equal(x.output, y.output)
    assert_tokens(a, want)


def test_concurrent_serve_first_completion_wins(serve_setup):
    """Threaded mode: duplicates race; a straggler + fail-stop replica
    still yields complete, deterministic outputs, the JAX executor's."""
    model, params, prompts, want = serve_setup
    ref = make_requests(prompts)
    RDLBServeExecutor(model, params, n_workers=1).serve(ref)
    reqs = make_requests(prompts)
    ex = RDLBServeExecutor(model, params, n_workers=3, technique="SS",
                           concurrent=True)
    ex.slow[0] = 0.02                        # straggler replica
    stats = ex.serve(reqs, fail_at={1: 1})   # fail-stop replica
    assert not stats.hung
    assert 1 in ex.dead
    for x, y in zip(reqs, ref):
        assert x.output is not None and np.array_equal(x.output, y.output)
    assert_tokens(reqs, want)


def test_concurrent_serve_hang_without_rdlb(serve_setup):
    """Without rDLB a fail-stop hangs the run; the requests that did
    finish carry the JAX executor's tokens."""
    model, params, prompts, want = serve_setup
    reqs = make_requests(prompts[:4])
    ex = RDLBServeExecutor(model, params, n_workers=2, technique="SS",
                           rdlb_enabled=False, concurrent=True)
    stats = ex.serve(reqs, fail_at={1: 0})
    assert stats.hung
    done = [(r.output, w) for r, w in zip(reqs, want) if r.output is not None]
    assert 0 < len(done) < len(reqs)
    for got, w in done:
        np.testing.assert_array_equal(got, w)


def _serve(model, params, prompts, new, n_workers=2, cls=RDLBServeExecutor,
           req=Request, **kw):
    reqs = [req(i, p, max_new_tokens=new) for i, p in enumerate(prompts)]
    ex = cls(model, params, n_workers=n_workers, technique="SS", **kw)
    stats = ex.serve(reqs)
    assert not stats.hung
    return [r.output for r in reqs]


@pytest.mark.parametrize("batch_decode", [False, True])
def test_executor_fused_matches_loop(batch_decode):
    """fused_decode=True is invisible in outputs for both the batched
    group path and the per-request baseline path; the per-token loop's
    tokens are the JAX executor's loop's."""
    jm, jp, model, params = pair(FUSED_CFG)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, FUSED_CFG.vocab_size, size=6).astype(np.int32)
               for _ in range(5)]
    loop = _serve(model, params, prompts, 3, batch_decode=batch_decode,
                  fused_decode=False)
    fused = _serve(model, params, prompts, 3, batch_decode=batch_decode,
                   fused_decode=True)
    want = _serve(jm, jp, prompts, 3, cls=JRDLBServeExecutor, req=JRequest,
                  batch_decode=batch_decode, fused_decode=False)
    for a, b, w in zip(loop, fused, want):
        assert np.array_equal(a, b)
        np.testing.assert_array_equal(a, w)


# ------------------------------------------------------ legacy keywords
def test_legacy_keywords_warn_and_build_the_reference_spec(serve_setup):
    """Legacy keywords warn and build the spec the reference's executor
    builds from them; without any, no warning and the default spec."""
    model, params, _, _ = serve_setup
    with pytest.warns(DeprecationWarning, match="RDLBServeExecutor"):
        ex = RDLBServeExecutor(model, params, **LEGACY)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jex = JRDLBServeExecutor(*pair(FUSED_CFG)[:2], **LEGACY)
    assert ex.spec.to_json() == jex.spec.to_json()
    assert ex.spec == api.serve_spec(technique="GSS", n_workers=3,
                                     rdlb_enabled=False, max_duplicates=2,
                                     threaded=True)
    assert ex.n_workers == 3
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        plain = RDLBServeExecutor(model, params)
    assert plain.spec == api.serve_spec()
    assert plain.batch_decode and plain.fused_decode


@pytest.mark.parametrize("key", sorted(LEGACY))
def test_legacy_keyword_with_spec_raises(serve_setup, key):
    model, params, _, _ = serve_setup
    with pytest.raises(TypeError, match=key):
        RDLBServeExecutor(model, params, spec=api.serve_spec(),
                          **{key: LEGACY[key]})


def test_fail_worker_persists_and_concurrent_overrides_one_call(
        serve_setup):
    """A worker failed by ``fail_worker`` takes no request in any later
    serve; ``serve(concurrent=True)`` runs that call in threads and
    leaves the spec's mode as it was; the tokens stay the JAX
    executor's."""
    model, params, prompts, want = serve_setup
    ex = RDLBServeExecutor(model, params,
                           spec=api.serve_spec(technique="SS", n_workers=3))
    ex.fail_worker(2)
    threads = set()
    chunk = ex._generate_chunk

    def spy(reqs):
        threads.add(threading.current_thread().name)
        return chunk(reqs)

    ex._generate_chunk = spy
    for concurrent in (None, True):
        threads.clear()
        reqs = make_requests(prompts)
        st = ex.serve(reqs, concurrent=concurrent)
        assert not st.hung and st.by_worker.get(2, 0) == 0
        assert 2 in ex.dead
        assert_tokens(reqs, want)
        on_main = threads == {threading.main_thread().name}
        assert on_main == (concurrent is None), threads
    assert ex.spec.execution.mode == "virtual"


def test_generate_is_the_per_request_baseline(serve_setup):
    model, params, prompts, want = serve_setup
    ex = RDLBServeExecutor(model, params)
    for r, w in zip(make_requests(prompts[:3]), want):
        np.testing.assert_array_equal(ex._generate(r), w)
