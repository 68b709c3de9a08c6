"""Parts of the port's other model families against the JAX package on
the CPU: MoE routing and dispatch (capacity drops, top-k ties), the
chunked ``flash_attend`` with a window or a prefix, the selective scan
streamed token by token and its backward's cost, hymba's meta prefix,
and threaded rDLB serving of the MoE and hybrid smoke configs through a
fail-stop.  The helpers and the tolerances are those of
tests/test_torch_families.py; the scan's backward is held to its
indexed form bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.runtime.serve_executor import FusedGenerator as JFused
from repro_torch import api
from repro_torch.launch.op_analysis import Counter
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_reference
from repro_torch.runtime import RDLBServeExecutor, Request, serve_executor
from test_torch_serve import _WaitForWorker1
from test_torch_families import (JCONFIGS, _close, _one_intra_op_thread,  # noqa: F401
                                 inputs, np_params, pair)


# the reference donates its caches, which the CPU cannot use
pytestmark = pytest.mark.filterwarnings("ignore:Some donated buffers")

def specs_of(fn):
    """A stand-in model whose ``param_specs`` are ``fn()``, for
    ``params_from_reference`` of one module's parameters."""
    return type("Specs", (), {"param_specs": lambda self: fn()})()


# ---------------------------------------------------------------- MoE
def test_route_and_dispatch_match_jax_with_drops_and_a_tie():
    """_route and _dispatch_combine of 3 groups of 12 tokens over 6
    experts, top-2, with capacity 2 (most tokens overflow some expert and
    are dropped) and logits that tie on purpose: a token whose 6 logits
    are equal, and tokens whose second and third choices are equal."""
    rng = np.random.default_rng(0)
    G, Tg, E, K, C = 3, 12, 6, 2, 2
    logits = rng.standard_normal((G, Tg, E)).astype(np.float32)
    logits[0, 0] = 0.5                        # a full tie: experts 0, 1
    logits[1, :4, 4] = logits[1, :4, 2] = 3.0  # ties between 2 and 4
    logits[2, 5, [1, 3]] = 2.0
    logits[2, 5, 5] = 4.0                     # 5, then 1 before 3
    jr = jax.vmap(lambda lg: jmoe._route(lg, K, E, 0.01))(logits)
    gates, idx, aux = tmoe._route(torch.from_numpy(logits), K, E, 0.01)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jr[1]))
    assert idx[0, 0].tolist() == [0, 1]
    assert idx[1, 0].tolist() == [2, 4] and idx[2, 5].tolist() == [5, 1]
    np.testing.assert_allclose(gates.numpy(), np.asarray(jr[0]), atol=1e-6)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jr[2]), rtol=1e-6)
    jd = jax.vmap(lambda i, g: jmoe._dispatch_combine(
        i, g, E, C, jnp.float32))(jr[1], jr[0])
    disp, comb = tmoe._dispatch_combine(idx, gates, E, C, torch.float32)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jd[0]))
    np.testing.assert_allclose(comb.numpy(), np.asarray(jd[1]), atol=1e-6)
    kept = disp.sum(dim=(-1, -2))             # slots a token holds
    assert int((kept < K).sum()) > 0          # some assignments dropped
    assert int(disp.sum(dim=1).max()) <= 1    # a slot holds one token


@pytest.mark.parametrize("cf", [0.25, 1.25])
def test_moe_apply_matches_jax_with_drops(cf):
    """moe_apply at a capacity factor that drops most assignments
    (C = 1) and at the default, with groups of 8 of 24 tokens."""
    cfg = JCONFIGS["deepseek-v2-lite"].replace(capacity_factor=cf,
                                               moe_group_size=8)
    tcfg = ModelConfig.from_reference(cfg)
    specs = jmoe.moe_specs(cfg)
    jp = np_params(specs, 3)
    tp = params_from_reference(specs_of(lambda: tmoe.moe_specs(tcfg)), jp,
                               device="cpu")
    x = np.random.default_rng(7).standard_normal((2, 12, cfg.d_model),
                                                 dtype=np.float32)
    jout, jaux = jmoe.moe_apply(jp, cfg, x)
    tout, taux = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    _close(tout, jout, atol=1e-5)
    assert abs(float(taux) - float(jaux)) <= 1e-6


def test_top_k_keeps_the_lower_index_first():
    p = torch.tensor([[0.1, 0.3, 0.3, 0.0, 0.3]])
    vals, idx = tmoe.top_k(p, 3)
    want = jax.lax.top_k(jnp.asarray(p.numpy()), 3)
    assert idx.tolist() == [[1, 2, 4]] == np.asarray(want[1]).tolist()


# ---------------------------------------------------------- attention
@pytest.mark.parametrize("window,prefix,skip", [
    (0, 0, True), (5, 0, False), (0, 6, False), (7, 3, False)])
def test_flash_attend_matches_jax(window, prefix, skip):
    """The chunked flash_attend (chunks of 4 over 16 positions) with a
    window, a prefix, both, and the causal-skip schedule."""
    rng = np.random.default_rng(window + prefix)
    q, k, v = (rng.standard_normal((2, 16, 3, 8), dtype=np.float32)
               for _ in range(3))
    kw = dict(window=window, prefix_len=prefix, causal_skip=skip,
              q_chunk=4, kv_chunk=4)
    want = jattn.flash_attend(q, k, v, 0.3, **kw)
    got = tattn.flash_attend(*(torch.from_numpy(a) for a in (q, k, v)),
                             0.3, **kw)
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("window,prefix", [(5, 0), (0, 6)])
def test_gqa_forward_at_a_small_flash_threshold_matches_jax(window,
                                                            prefix):
    """gqa_forward with a window or a prefix at or above a flash_threshold
    of 8 takes the chunked flash_attend in both packages."""
    jcfg = JCONFIGS["hymba"].replace(flash_threshold=8)
    tcfg = ModelConfig.from_reference(jcfg)
    jp = np_params(jattn.gqa_specs(jcfg), 1)
    tp = params_from_reference(specs_of(lambda: tattn.gqa_specs(tcfg)), jp,
                               device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 12, jcfg.d_model),
                                                 dtype=np.float32)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12))
    want = jattn.gqa_forward(jp, jcfg, x, pos, window=window,
                             prefix_len=prefix)
    got = tattn.gqa_forward(tp, tcfg, torch.from_numpy(x),
                            torch.from_numpy(pos.copy()), window=window,
                            prefix_len=prefix)
    _close(got, want, atol=1e-5)


# ---------------------------------------------------------------- SSM
def test_mamba_streamed_token_by_token_equals_one_pass():
    """mamba_apply over 10 tokens at once equals 10 one-token calls that
    carry the SSM state and conv tail, and the reference's one pass."""
    jcfg = JCONFIGS["hymba"]
    tcfg = ModelConfig.from_reference(jcfg)
    di = int(jcfg.ssm_expand * jcfg.d_model)
    jp = np_params(jssm.mamba_specs(jcfg, di), 4)
    jp["a_log"] = np.random.default_rng(1).uniform(
        -1, 1, jp["a_log"].shape).astype(np.float32)
    tp = params_from_reference(specs_of(lambda: tssm.mamba_specs(tcfg, di)),
                               jp, device="cpu")
    x = np.random.default_rng(5).standard_normal((2, 10, jcfg.d_model),
                                                 dtype=np.float32)
    s0 = np.zeros((2, di, jcfg.ssm_state), np.float32)
    jy, js, jt = jssm.mamba_apply(jp, jcfg, x, s0, None)
    xt = torch.from_numpy(x)
    y, s, t = tssm.mamba_apply(tp, tcfg, xt, torch.from_numpy(s0), None)
    _close(y, jy, atol=1e-5)
    _close(s, js, atol=1e-5)
    _close(t, jt, atol=1e-6)
    st = torch.from_numpy(s0)
    tail = torch.zeros((2, jcfg.ssm_conv - 1, di))
    ys = []
    for i in range(10):
        yi, st, tail = tssm.mamba_apply(tp, tcfg, xt[:, i:i + 1], st, tail)
        ys.append(yi)
    _close(torch.cat(ys, dim=1), y.numpy(), atol=1e-5, rtol=1e-5)
    _close(st, s.numpy(), atol=1e-5, rtol=1e-5)
    _close(tail, t.numpy(), atol=1e-6, rtol=1e-6)


def _scan_inputs(S: int, seed: int = 0) -> list:
    g = torch.Generator().manual_seed(seed)
    B, Di, N = 2, 16, 4
    return [torch.rand(B, S, Di, generator=g),
            torch.randn(B, S, N, generator=g),
            torch.randn(B, S, N, generator=g),
            torch.randn(B, S, Di, generator=g),
            -torch.rand(Di, N, generator=g),
            torch.randn(B, Di, N, generator=g)]


def _indexed_scan(dt, Bm, Cm, xx, A, h):
    """The selective scan with each step indexing dA[:, t]: the same
    arithmetic as ``selective_scan``, with a backward quadratic in S."""
    dA = torch.exp(dt[..., None] * A)
    dBx = (dt * xx)[..., None] * Bm[:, :, None, :]
    hs = []
    for t in range(dt.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        hs.append(h)
    return (torch.stack(hs, dim=1) * Cm[:, :, None, :]).sum(dim=-1), h


def test_selective_scan_backward_is_linear_in_S():
    """The scan's counted forward + backward bytes grow at most 4.5x from
    S = 64 to 4S (the indexed form grows about 15x); its outputs and
    gradients equal the indexed form's bit for bit."""
    def scan_and_grads(fn, S):
        ins = [t.requires_grad_() for t in _scan_inputs(S)]
        y, h = fn(*ins)
        (0.5 * y.sum() + (h * h).sum()).backward()
        return [y, h] + [t.grad for t in ins]

    for S in (1, 37):
        got = scan_and_grads(tssm.selective_scan, S)
        want = scan_and_grads(_indexed_scan, S)
        for a, b in zip(got, want):
            assert torch.equal(a, b), S

    def counted_bytes(S):
        with Counter() as c:
            y, _ = tssm.selective_scan(
                *[t.requires_grad_() for t in _scan_inputs(S)])
            y.sum().backward()
        return c.unfused_bytes

    ratio = counted_bytes(256) / counted_bytes(64)
    assert ratio <= 4.5, ratio


def test_hymba_meta_prefill_then_decode_matches_forward():
    """Decode after prefill_meta reproduces the forward pass's logits
    (the meta prefix fed through the decode path)."""
    _, _, tm, tp = pair("hymba")
    toks = torch.from_numpy(inputs("hymba", B=2, S=8, seed=6)["tokens"])
    with torch.inference_mode():
        full = tm.forward(tp, toks)
        cache = tm.prefill_meta(tp, tm.init_cache(2, 8, device="cpu"), 2)
        outs = []
        for pos in range(8):
            lg, cache = tm.decode_step(tp, cache, toks[:, pos:pos + 1], pos)
            outs.append(lg[:, 0])
    _close(torch.stack(outs, dim=1), full.numpy(), atol=1e-4, rtol=1e-3)


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("key", ["deepseek-v2-lite", "hymba"])
def test_threaded_serving_survives_a_fail_stop(key, monkeypatch):
    """Threaded rDLB (SS, P=4) over 9 requests of prompt lengths 5, 8 and
    13; worker 1 fail-stops holding its second request (the others wait
    for it, ``_WaitForWorker1``, so the fail-stop happens in every run).
    Every request's tokens equal a failure-free run's and the reference
    FusedGenerator's, with at least one duplicate."""
    jm, jp, tm, tp = pair(key)
    vocab = JCONFIGS[key].vocab_size
    spec = api.serve_spec(technique="SS", n_workers=4, threaded=True)

    def requests():
        r = np.random.default_rng(8)
        return [Request(i, r.integers(0, vocab, size=(5, 8, 13)[i % 3])
                        .astype(np.int32), max_new_tokens=4)
                for i in range(9)]

    reqs = requests()
    ex = RDLBServeExecutor(tm, tp, spec=spec)
    with monkeypatch.context() as m:
        m.setattr(serve_executor, "ServeBackend", _WaitForWorker1)
        st = ex.serve(reqs, fail_at={1: 1})
    assert not st.hung and st.n_duplicates >= 1 and 1 in ex.dead
    calm = requests()
    assert not RDLBServeExecutor(tm, tp, spec=spec).serve(calm).hung
    jgen = JFused(jm)
    for a, b in zip(reqs, calm):
        np.testing.assert_array_equal(a.output, b.output)
        np.testing.assert_array_equal(
            a.output, jgen(jp, a.prompt[None], 4)[0])
