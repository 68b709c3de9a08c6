"""The port's full-sequence attention (``repro_torch.kernels.
flash_attention``: the plain version, which CPU tensors take, and the
backward of ``FlashAttentionFn``) against the JAX package's Pallas kernel
in interpret mode (as ``tests/test_kernels.py`` runs it) and its oracles.

Tolerances, as ``tests/test_kernels.py`` states them for the JAX kernel:
1e-5 absolute in float32, 3e-2 in bfloat16 (one rounding of outputs of
order 1).  Gradients against ``jax.grad`` of ``ref.attention`` in float32
within 1e-5 absolute (the two sum in other orders); the backward's own
check is ``torch.autograd.gradcheck`` in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import dispatch
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = {jnp.float32: 1e-5, jnp.bfloat16: 3e-2}


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


def _inputs(seed, *shapes, dtype=jnp.float32):
    """numpy-seeded normals as (jax arrays in ``dtype``, torch tensors
    holding the same values)."""
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.standard_normal(s, dtype=np.float32), dtype)
          for s in shapes]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    ts = [torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in js]
    return js, ts


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


@pytest.mark.parametrize("B,S,D,bq,bk", [
    (2, 128, 32, 64, 64), (1, 256, 64, 128, 64), (3, 64, 16, 64, 64),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_attention_matches_jax_kernel(B, S, D, bq, bk, causal, dtype):
    """Twin of tests/test_kernels.py::test_flash_attention_matches_ref:
    the port against the Pallas kernel and against ``ref.attention``."""
    (q, k, v), (tq, tk, tv) = _inputs(B * S + D, (B, S, D), (B, S, D),
                                      (B, S, D), dtype=dtype)
    want_kernel = jops.flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)
    want_ref = jref.attention(q, k, v, causal=causal)
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == (B, S, D)
    assert dispatch.status("flash_attention")["path"] == "torch"
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])
    np.testing.assert_allclose(
        _np(tref.attention(tq, tk, tv, causal=causal)), _np(want_ref),
        atol=TOL[dtype])


def test_flash_attention_mixed_dv():
    """MLA-style: qk dim != v dim (tests/test_kernels.py)."""
    (q, k, v), ts = _inputs(0, (2, 128, 48), (2, 128, 48), (2, 128, 32))
    want = jops.flash_attention(q, k, v, causal=True, bq=64, bk=64)
    got = tops.flash_attention(*ts, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    np.testing.assert_allclose(
        _np(got), _np(jref.attention(q, k, v, causal=True,
                                     scale=48 ** -0.5)), atol=1e-5)


def test_mha_flash_wrapper():
    """Twin of tests/test_kernels.py::test_mha_flash_wrapper."""
    (q, k, v), ts = _inputs(1, *[(2, 128, 4, 32)] * 3)
    want = jops.mha_flash(q, k, v)
    got = tops.mha_flash(*ts)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    for h in range(4):
        np.testing.assert_allclose(
            _np(got[:, :, h]),
            _np(jref.attention(q[:, :, h], k[:, :, h], v[:, :, h])),
            atol=1e-5)


@pytest.mark.parametrize("S,H,KV,causal", [(100, 4, 2, True),
                                           (100, 4, 1, False),
                                           (37, 6, 3, True)])
def test_ragged_gqa_matches_dense_attend(S, H, KV, causal):
    """Any S and GQA through strides: against the reference model's
    dense path, ``_attend`` over ``_repeat_kv`` copies."""
    B, D = 2, 16
    (q, k, v), ts = _inputs(S + H, (B, S, H, D), (B, S, KV, D),
                            (B, S, KV, D))
    mask = (jattn.causal_mask(S, S) if causal
            else jnp.ones((S, S), bool))
    g = H // KV
    want = jattn._attend(q, jattn._repeat_kv(k, g), jattn._repeat_kv(v, g),
                         mask, D ** -0.5)
    got = tops.flash_attention_gqa(*ts, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_strided_views_are_read_in_place():
    """q and k as slices of one (B, S, H + KV, D) tensor, as the model's
    rotary step leaves them, give the contiguous inputs' result."""
    _, (qk, v) = _inputs(5, (1, 50, 6, 8), (1, 50, 2, 8))
    q, k = qk[:, :, :4], qk[:, :, 4:]
    assert not q.is_contiguous()
    torch.testing.assert_close(
        tops.flash_attention_gqa(q, k, v),
        tops.flash_attention_gqa(q.contiguous(), k.contiguous(), v),
        rtol=0, atol=0)


def test_lse_is_the_rows_logsumexp():
    _, (q, k, v) = _inputs(2, (1, 20, 2, 8), (1, 20, 1, 8), (1, 20, 1, 4))
    for causal in (True, False):
        out, lse = kf.flash_attention_forward(q, k, v, causal=causal)
        s = torch.einsum("bqhd,bkd->bhqk", q, k[:, :, 0]) * 8 ** -0.5
        if causal:
            s = s.masked_fill(~torch.ones(20, 20).tril().bool(), -torch.inf)
        torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1),
                                   rtol=1e-6, atol=1e-6)
        assert out.shape == (1, 20, 2, 4) and lse.dtype == torch.float32


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tile", [None, 3])
def test_backward_passes_gradcheck(monkeypatch, causal, tile):
    """float64 gradcheck of FlashAttentionFn with GQA (H = 4 over KV = 2)
    and Dv != D, the backward's query tiles whole or 3 rows (ragged)."""
    if tile is not None:
        monkeypatch.setattr(kf, "BWD_TILE", tile)
    gen = torch.Generator().manual_seed(int(causal))
    mk = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64,  # noqa
                                requires_grad=True)
    q, k, v = mk(2, 10, 4, 3), mk(2, 10, 2, 3), mk(2, 10, 2, 5)
    assert torch.autograd.gradcheck(
        lambda a, b, c: kf.FlashAttentionFn.apply(a, b, c, causal, 0.6),
        (q, k, v))


@pytest.mark.parametrize("causal", [True, False])
def test_grads_match_jax_grad_of_ref(monkeypatch, causal):
    """dQ, dK, dV of the port (query tiles of 48 over S = 100) against
    ``jax.grad`` of ``ref.attention``, float32, Dv != D."""
    monkeypatch.setattr(kf, "BWD_TILE", 48)
    (q, k, v, do), (tq, tk, tv, tdo) = _inputs(
        11, (2, 100, 32), (2, 100, 32), (2, 100, 24), (2, 100, 24))

    def f(q, k, v):
        return jnp.sum(jref.attention(q, k, v, causal=causal) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    out = tops.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, tdo)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5)


def test_backward_agrees_with_autograd_of_plain_bf16():
    """bfloat16 inputs: the backward computes in float32 and rounds once;
    autograd through the plain version's ops agrees within bf16
    rounding of gradients of order 1."""
    _, ts = _inputs(3, (1, 40, 2, 16), (1, 40, 2, 16), (1, 40, 2, 16),
                    (1, 40, 2, 16), dtype=jnp.bfloat16)
    a = [t.clone().requires_grad_() for t in ts[:3]]
    b = [t.clone().requires_grad_() for t in ts[:3]]
    ga = torch.autograd.grad(tops.flash_attention_gqa(*a), a, ts[3])
    gb = torch.autograd.grad(kf.flash_attention_gqa_plain(*b), b, ts[3])
    for x, y in zip(ga, gb):
        assert x.dtype == torch.bfloat16
        torch.testing.assert_close(x.float(), y.float(), rtol=2e-2,
                                   atol=2e-2)


def test_bad_inputs_raise():
    z = torch.zeros
    with pytest.raises(ValueError, match="shapes"):
        tops.flash_attention_gqa(z(1, 4, 2, 8), z(1, 5, 2, 8), z(1, 5, 2, 8))
    with pytest.raises(ValueError, match="evenly"):
        tops.flash_attention_gqa(z(1, 4, 3, 8), z(1, 4, 2, 8), z(1, 4, 2, 8))
    with pytest.raises(TypeError, match="dtype"):
        tops.flash_attention_gqa(z(1, 4, 2, 8), z(1, 4, 2, 8),
                                 z(1, 4, 2, 8, dtype=torch.float64))
    before = dispatch.launches("flash_attention")
    tops.flash_attention(z(1, 4, 8), z(1, 4, 8), z(1, 4, 8))
    assert dispatch.launches("flash_attention") == before
