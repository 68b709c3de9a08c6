"""The port's decode kernels (``repro_torch.kernels``: flash_decode,
wkv6_decode, wkv6_batched, on the CPU through their plain PyTorch
versions) against the JAX package (its Pallas kernels in interpret mode
and its ``ref`` oracles), on the same inputs made with numpy.

Tolerances, each with its reason:
  * float32 attention: 1e-5.  Both accumulate in float32, in another
    order.
  * bfloat16 attention: 1e-2 absolute on outputs of order 1: one
    bfloat16 rounding of the output (2^-8 relative) apart.
  * wkv6 against the sequential ``ref.wkv6``: 1e-4 relative to the
    output's scale.  The chunked form sums the same terms in another
    order and through exp/log of the decays.
  * wkv6 against the JAX chunked kernel: 1e-3 relative to the output's
    scale.  The JAX kernel scales k by exp(-cumsum log w) and r by
    exp(cumsum log w): at w = 0.1 these factors reach 1e31 and 1e-31,
    and it loses digits there (the port's pairwise form does not).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import dispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _mask(L: int, bk: int, rng) -> np.ndarray:
    """Scattered validity, block 1 fully masked, slot 0 valid."""
    valid = rng.random(L) < 0.6
    valid[bk:2 * bk] = False
    valid[0] = True
    return valid


# -------------------------------------------------------------- flash_decode
@pytest.mark.parametrize("L,bk", [(12, 4), (128, 64), (200, 40)])
def test_flash_decode_matches_jax(L, bk):
    rng = np.random.default_rng(L)
    B, D, Dv = 3, 32, 16
    q = rng.standard_normal((B, D), dtype=np.float32)
    k = rng.standard_normal((B, L, D), dtype=np.float32)
    v = rng.standard_normal((B, L, Dv), dtype=np.float32)
    valid = _mask(L, bk, rng)
    want = np.asarray(jops.flash_decode(q, k, v, jnp.asarray(valid), bk=bk))
    oracle = np.asarray(jref.attention_decode(q, k, v, jnp.asarray(valid)))
    got = tops.flash_decode(_t(q), _t(k), _t(v), _t(valid))
    assert dispatch.status("flash_decode") == {"path": "torch"}
    assert got.dtype == torch.float32 and got.shape == (B, Dv)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-5)


def test_flash_decode_bf16_matches_jax():
    rng = np.random.default_rng(7)
    B, L, D = 4, 128, 64
    mk = lambda *s: jnp.asarray(rng.standard_normal(s, dtype=np.float32),
                                jnp.bfloat16)
    q, k, v = mk(B, D), mk(B, L, D), mk(B, L, D)
    valid = _mask(L, 32, rng)
    want = np.asarray(jops.flash_decode(q, k, v, jnp.asarray(valid), bk=32),
                      np.float32)
    tq, tk, tv = (_t(np.asarray(a, np.float32)).to(torch.bfloat16)
                  for a in (q, k, v))
    got = tops.flash_decode(tq, tk, tv, _t(valid))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2)


def test_flash_decode_fully_masked_row_is_zero():
    """No valid slot: the JAX kernel's re-zeroed probabilities give 0."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 16), dtype=np.float32)
    k = rng.standard_normal((2, 64, 16), dtype=np.float32)
    valid = np.zeros(64, bool)
    want = np.asarray(jops.flash_decode(q, k, k, jnp.asarray(valid), bk=32))
    got = tops.flash_decode(_t(q), _t(k), _t(k), _t(valid)).numpy()
    assert np.all(want == 0) and np.all(got == 0)


@pytest.mark.parametrize("H,KV", [(4, 2), (4, 1), (3, 3)])
def test_flash_decode_gqa_matches_folded_jax(H, KV):
    """The cache-layout entry equals the reference's repeat + transpose +
    flash_decode (``repro.models.attention.gqa_decode``)."""
    rng = np.random.default_rng(H * 10 + KV)
    B, L, D = 2, 40, 16
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    k = rng.standard_normal((B, L, KV, D), dtype=np.float32)
    v = rng.standard_normal((B, L, KV, D), dtype=np.float32)
    valid = _mask(L, 8, rng)
    fold = lambda t: np.repeat(t, H // KV, axis=2).transpose(
        0, 2, 1, 3).reshape(B * H, L, D)
    want = np.asarray(jops.flash_decode(q.reshape(B * H, D), fold(k),
                                        fold(v), jnp.asarray(valid), bk=8))
    got = tops.flash_decode_gqa(_t(q), _t(k), _t(v), _t(valid))
    np.testing.assert_allclose(got.reshape(B * H, D).numpy(), want,
                               atol=1e-5)


def test_flash_decode_rejects_bad_inputs():
    q, k = torch.zeros(2, 8), torch.zeros(2, 5, 8)
    with pytest.raises(ValueError, match="valid"):
        tops.flash_decode(q, k, k, torch.ones(4, dtype=torch.bool))
    with pytest.raises(TypeError, match="share a dtype"):
        tops.flash_decode(q, k.double(), k, torch.ones(5, dtype=torch.bool))
    with pytest.raises(ValueError, match="evenly"):
        tops.flash_decode_gqa(torch.zeros(1, 3, 8), torch.zeros(1, 5, 2, 8),
                              torch.zeros(1, 5, 2, 8),
                              torch.ones(5, dtype=torch.bool))


# ------------------------------------------------------------------ wkv6
def _wkv_inputs(rng, BH, T, dk, dv, w):
    shp = (BH, T, dk) if T else (BH, dk)
    r = rng.standard_normal(shp, dtype=np.float32)
    k = rng.standard_normal(shp, dtype=np.float32)
    v = rng.standard_normal(shp[:-1] + (dv,), dtype=np.float32)
    if w == "uniform":
        ww = rng.uniform(0.1, 1.0, shp).astype(np.float32)
    else:
        ww = np.full(shp, w, np.float32)
    u = rng.standard_normal((BH, dk), dtype=np.float32)
    s = rng.standard_normal((BH, dk, dv), dtype=np.float32)
    return r, k, v, ww, u, s


def _sequential(r, k, v, w, u, s):
    """JAX's ``ref.wkv6`` per head -> (y (BH, T, dv), state)."""
    ys, ss = [], []
    for b in range(r.shape[0]):
        y, st = jref.wkv6(r[b], k[b], v[b], w[b], u[b], s[b])
        ys.append(np.asarray(y))
        ss.append(np.asarray(st))
    return np.stack(ys), np.stack(ss)


def _close(got, want, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def test_wkv6_decode_matches_jax():
    rng = np.random.default_rng(11)
    r, k, v, w, u, s = _wkv_inputs(rng, 6, 0, 16, 8, "uniform")
    y_k, s_k = jops.wkv6_decode(r, k, v, w, u, s)
    y_ref, s_ref = _sequential(r[:, None], k[:, None], v[:, None],
                               w[:, None], u, s)
    y, st = tops.wkv6_decode(*map(_t, (r, k, v, w, u, s)))
    assert dispatch.status("wkv6_decode") == {"path": "torch"}
    _close(y, np.asarray(y_k), 1e-5)
    _close(st, np.asarray(s_k), 1e-5)
    _close(y, y_ref[:, 0], 1e-5)
    _close(st, s_ref, 1e-5)


def test_wkv6_decode_writes_state_in_place():
    rng = np.random.default_rng(12)
    ins = [_t(a) for a in _wkv_inputs(rng, 3, 0, 8, 8, 0.5)]
    want_y, want_s = tref.wkv6_decode(*ins)
    state = ins[5].clone()
    y, out = tops.wkv6_decode(*ins[:5], state, out_state=state)
    assert out is state
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(state, want_s, rtol=0, atol=0)


@pytest.mark.parametrize("w", ["uniform", 0.1])
@pytest.mark.parametrize("T", [32, 64, 37])
def test_wkv6_batched_matches_jax_kernel(T, w):
    """Against the Pallas kernel with the chunk its caller would pick
    (the largest divisor of T up to 32: 1 for T = 37) and against the
    sequential oracle."""
    rng = np.random.default_rng(T)
    r, k, v, ww, u, s = _wkv_inputs(rng, 4, T, 16, 16, w)
    jchunk = max(c for c in range(1, 33) if T % c == 0)
    y_k, s_k = jops.wkv6_batched(r, k, v, ww, u, s, chunk=jchunk)
    y_ref, s_ref = _sequential(r, k, v, ww, u, s)
    y, st = tops.wkv6_batched(*map(_t, (r, k, v, ww, u, s)))
    assert dispatch.status("wkv6_batched") == {"path": "torch"}
    assert y.shape == (4, T, 16) and y.dtype == torch.float32
    _close(y, np.asarray(y_k), 1e-3)
    _close(st, np.asarray(s_k), 1e-3)
    _close(y, y_ref, 1e-4)
    _close(st, s_ref, 1e-4)


def test_wkv6_batched_strong_decay_stays_finite():
    """w = 0.01: the JAX chunked kernel overflows (exp(-cumsum log w)
    reaches e^147 in a 32-row chunk) and returns NaN; the port's pairwise
    form matches the sequential oracle."""
    rng = np.random.default_rng(5)
    r, k, v, ww, u, s = _wkv_inputs(rng, 2, 64, 16, 16, 0.01)
    y_k, _ = jops.wkv6_batched(r, k, v, ww, u, s, chunk=32)
    assert not np.isfinite(np.asarray(y_k)).all()
    y_ref, s_ref = _sequential(r, k, v, ww, u, s)
    y, st = tops.wkv6_batched(*map(_t, (r, k, v, ww, u, s)))
    assert torch.isfinite(y).all()
    _close(y, y_ref, 1e-4)
    _close(st, s_ref, 1e-4)


@pytest.mark.parametrize("chunk", [1, 5, 32])
def test_wkv6_single_head_matches_ref(chunk):
    """``wkv6`` (single head, any chunk, ragged last chunk) against the
    sequential oracle; y comes back in r's dtype."""
    rng = np.random.default_rng(chunk)
    r, k, v, ww, u, s = (a[0] for a in _wkv_inputs(rng, 1, 23, 8, 8,
                                                   "uniform"))
    y_ref, s_ref = jref.wkv6(r, k, v, ww, u, s)
    y, st = tops.wkv6(*map(_t, (r, k, v, ww, u, s)), chunk=chunk)
    _close(y, np.asarray(y_ref), 1e-4)
    _close(st, np.asarray(s_ref), 1e-4)
