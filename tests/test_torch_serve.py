"""The port's serving path (``repro_torch.runtime``: FusedGenerator,
the rDLB serve executor, the ``launch.serve`` command line) on the CPU,
against the JAX package's ``FusedGenerator`` and against its own
failure-free runs.

Tolerance: none.  Greedy tokens are compared exactly: on float32 configs
the logits of the two packages agree to float32 rounding
(tests/test_torch_models.py), far inside the gaps between the top two
logits of these prompts, and within the port decoding is deterministic.
"""

import threading

import jax
import numpy as np
import pytest

from repro.models import build_model as jbuild
from repro.models.config import ModelConfig as JModelConfig
from repro.configs import get_smoke as jget_smoke
from repro.runtime.serve_executor import FusedGenerator as JFusedGenerator
from repro_torch import api
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_reference
from repro_torch.runtime import RDLBServeExecutor, Request, serve_executor
from repro_torch.runtime.backends import ServeBackend
from repro_torch.runtime.serve_executor import (FusedGenerator,
                                                greedy_decode_group)

# the reference donates its caches, which the CPU cannot use
pytestmark = pytest.mark.filterwarnings("ignore:Some donated buffers")

JCONFIGS = {
    "dense": JModelConfig(family="dense", n_layers=2, d_model=64, n_heads=2,
                          n_kv_heads=2, d_ff=128, vocab_size=128,
                          dtype="float32"),
    "rwkv": JModelConfig(family="rwkv", n_layers=2, d_model=64, n_heads=2,
                         d_ff=128, vocab_size=128, dtype="float32",
                         rwkv_head_dim=16),
    "qwen3-smoke": jget_smoke("qwen3-4b").replace(dtype="float32"),
}


def pair(key):
    jcfg = JCONFIGS[key]
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(ModelConfig.from_reference(jcfg))
    tp = params_from_reference(tm, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("key", list(JCONFIGS))
def test_fused_tokens_equal_jax_fused(key):
    """The port's FusedGenerator emits the reference FusedGenerator's
    tokens exactly, and so does its own per-token loop; B=3 exercises the
    pad-to-pow2 rows."""
    jm, jp, tm, tp = pair(key)
    jgen, tgen = JFusedGenerator(jm), FusedGenerator(tm)
    rng = np.random.default_rng(0)
    for B, S, new in [(1, 7, 4), (3, 12, 5)]:
        prompts = rng.integers(0, JCONFIGS[key].vocab_size,
                               size=(B, S)).astype(np.int32)
        want = jgen(jp, prompts, new)
        got = tgen(tp, prompts, new)
        assert got.shape == (B, new) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        loop = greedy_decode_group(tm, tp, tm.decode_step, prompts, new)
        np.testing.assert_array_equal(loop, want)


def _requests(vocab, n, lengths, new, seed):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, size=lengths[i % len(
        lengths)]).astype(np.int32), max_new_tokens=new) for i in range(n)]


class _WaitForWorker1(ServeBackend):
    """A ServeBackend whose other workers hold their chunk until worker
    1's thread has ended (or ``timeout`` seconds pass).  Worker 1 then
    takes a request while the others hold theirs, and asks for another
    while theirs are unfinished, whatever the order the threads run in:
    with ``fail_at={1: 1}`` it fail-stops holding that second request."""

    timeout = 60.0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._worker1 = None
        self._seen = threading.Event()

    def execute(self, chunk, wid):
        if wid == 1:
            self._worker1 = threading.current_thread()
            self._seen.set()
        elif self._seen.wait(self.timeout):
            self._worker1.join(self.timeout)
        return super().execute(chunk, wid)


@pytest.mark.parametrize("key", ["dense", "rwkv"])
def test_threaded_fail_stop_tokens_equal_calm_run(key, monkeypatch):
    """Threaded rDLB (SS, P=3) with a worker that fail-stops after one
    request: every request completes, duplicates were issued, and the
    tokens equal a failure-free run and the reference's generator.  The
    other workers wait for worker 1 (``_WaitForWorker1``), so its
    fail-stop happens in every run."""
    jm, jp, tm, tp = pair(key)
    vocab = JCONFIGS[key].vocab_size
    spec = api.serve_spec(technique="SS", n_workers=3, threaded=True)
    reqs = _requests(vocab, 6, [5, 9], 3, seed=4)
    ex = RDLBServeExecutor(tm, tp, spec=spec)
    with monkeypatch.context() as m:
        m.setattr(serve_executor, "ServeBackend", _WaitForWorker1)
        stats = ex.serve(reqs, fail_at={1: 1})
    assert not stats.hung and stats.n_duplicates >= 1
    assert 1 in ex.dead and stats.by_worker.get(1) == 1
    calm = _requests(vocab, 6, [5, 9], 3, seed=4)
    cstats = RDLBServeExecutor(tm, tp, spec=spec).serve(calm)
    assert not cstats.hung
    jgen = JFusedGenerator(jm)
    for r, c in zip(reqs, calm):
        np.testing.assert_array_equal(r.output, c.output)
        np.testing.assert_array_equal(
            r.output, jgen(jp, r.prompt[None], 3)[0])


def test_executor_paths_agree():
    """The executor's grouped path (virtual mode, prompts of two lengths,
    so a chunk holds groups of several shapes) gives each request the
    tokens of the per-token loop run on that request alone."""
    _, _, tm, tp = pair("dense")
    reqs = _requests(128, 7, [6, 6, 9], 3, seed=1)
    ex = RDLBServeExecutor(tm, tp, spec=api.serve_spec(n_workers=2))
    assert not ex.serve(reqs).hung
    for r in reqs:
        np.testing.assert_array_equal(
            r.output, greedy_decode_group(tm, tp, tm.decode_step,
                                          r.prompt[None], 3)[0])


def test_process_mode_names_its_roadmap_item():
    _, _, tm, tp = pair("dense")
    spec = api.serve_spec(n_workers=2).override("execution.mode", "process")
    with pytest.raises(NotImplementedError, match="A8"):
        RDLBServeExecutor(tm, tp, spec=spec).serve(
            _requests(128, 2, [4], 2, seed=0))


@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-1.6b"])
def test_launch_serve_on_cpu(arch, capsys):
    stats = tserve.main(["--arch", arch, "--smoke", "--requests", "6",
                         "--n-workers", "3", "--fail-worker", "1",
                         "--prompt-len", "5", "--max-new-tokens", "2",
                         "--device", "cpu"])
    assert not stats.hung and stats.n_requests == 6
    assert "served 6/6 requests" in capsys.readouterr().out
