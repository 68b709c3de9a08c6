"""The design decisions of the Hopper attention kernels, on the CPU:
which full-sequence variant a call gets, the bound that rounding the
probabilities to bfloat16 (the wgmma variant) can move the output by,
and the decode kernel's split of a cache row over a thread-block cluster
(``decode_splits``, ``split_ranges`` and the plain mirror of the
per-split states and their merge in rank order).

Tolerances: the split mirror against ``flash_decode_plain`` within 1e-6
(float32: the same terms summed in another order), and against the JAX
Pallas kernel in interpret mode within 1e-5, as
``tests/test_torch_decode_kernels.py`` holds the plain version.  The
rounding bound is held with no slack: the float32 differences of
summation order are about 1e-7 of it.  The wgmma variant's mirror against
the JAX full-sequence kernel in interpret mode: within 1e-5 with P in
float32, within the rounding bound + 1e-5 with P rounded.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import dispatch
from repro_torch.kernels import flash_attention as kf


# ------------------------------------------------------ variant choice
@pytest.mark.parametrize("dtype,D,Dv,variant", [
    (torch.bfloat16, 128, 128, "wgmma"), (torch.bfloat16, 64, 64, "wgmma"),
    (torch.bfloat16, 256, 256, "wgmma"), (torch.bfloat16, 192, 128, "wgmma"),
    (torch.bfloat16, 256, 128, "fp32"), (torch.bfloat16, 192, 192, "fp32"),
    (torch.bfloat16, 128, 64, "fp32"), (torch.bfloat16, 16, 8, "fp32"),
    (torch.bfloat16, 96, 96, "fp32"), (torch.float32, 128, 128, "fp32"),
    (torch.float32, 64, 64, "fp32"), (torch.float32, 256, 256, "fp32"),
    (torch.float32, 192, 128, "fp32"),
])
def test_attention_variant_choice(dtype, D, Dv, variant):
    """bfloat16 with (D, Dv) in ``WGMMA_DIMS`` (the dense models' 64 and
    128, paligemma's 256, MLA's 192 / 128) takes the tensor cores; float32
    (exact float32 products) and every other head-dim pair the fp32
    kernel."""
    q, k = (torch.zeros((2, 3, 4, D), dtype=dtype) for _ in range(2))
    v = torch.zeros((2, 3, 4, Dv), dtype=dtype)
    assert kf.attention_variant(q, k, v) == variant
    if dtype == torch.bfloat16:
        assert ((D, Dv) in kf.WGMMA_DIMS) == (variant == "wgmma")


def test_attention_variant_takes_fp32_where_tma_cannot_load():
    """A bfloat16 head dim of 128 read out of rows of 129 (strides not a
    multiple of 8 elements), or from a base 2 bytes past 16-byte
    alignment, takes the fp32 variant, which reads through any strides;
    the same values laid out contiguously take wgmma."""
    rows = torch.zeros((1, 64, 2, 129), dtype=torch.bfloat16)[..., :128]
    assert kf.attention_variant(rows, rows, rows) == "fp32"
    assert kf.attention_variant(rows.contiguous(), rows.contiguous(),
                                rows.contiguous()) == "wgmma"
    flat = torch.zeros(1 + 64 * 2 * 128, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 64, 2, 128)
    assert shifted.data_ptr() % 16 == 2
    assert kf.attention_variant(shifted, shifted, shifted) == "fp32"


def test_size_one_dims_get_strides_tma_takes():
    """The stride of a size-1 dim is never followed, so it is replaced by
    the one it would have on top of the dim below: a (1, S, 1, 128) view
    whose size-1 dims carry odd strides still takes wgmma, and the
    strides of dims of size > 1 pass through as they are."""
    base = torch.zeros((64, 128), dtype=torch.bfloat16)
    odd = base.as_strided((1, 64, 1, 128), (3, 128, 5, 1))
    assert kf._strides(odd) == (64 * 128, 128, 128)
    assert kf.attention_variant(odd, odd, odd) == "wgmma"
    rows = torch.zeros((2, 64, 4, 129), dtype=torch.bfloat16)[..., :128]
    assert kf._strides(rows) == rows.stride()[:3]


@pytest.mark.parametrize("arch", ["paligemma-3b", "deepseek-v2-lite-16b"])
def test_model_paths_hand_tma_ready_tensors_to_the_wgmma_variant(
        arch, monkeypatch):
    """The tensors the models pass to flash_attention at their full head
    dims take the wgmma variant (on the card): paligemma's prefill views
    q and k out of one roped (B, S, H + KV, 256) tensor and v from its own
    projection; MLA's forward concatenates q = [q_nope; q_rope] and
    k = [k_nope; k_rope] (192) beside v (128).  Strides a TMA load cannot
    take would send them to the fp32 variant silently.  bf16 on the CPU
    at narrow widths (the plain version runs; the choice reads only
    dtype, head dims, base alignment and strides)."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    wide = {"paligemma-3b": dict(n_heads=8, d_head=256),
            "deepseek-v2-lite-16b": dict(nope_head_dim=128, rope_head_dim=64,
                                         v_head_dim=128)}[arch]
    cfg = get_smoke(arch).replace(**wide)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 21)))
    seen, real = [], ops.flash_attention_gqa

    def capture(q, k, v, **kw):
        seen.append(((q.shape[-1], v.shape[-1]), q.dtype,
                     kf.attention_variant(q, k, v)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention_gqa", capture)
    with torch.inference_mode():
        if arch == "paligemma-3b":
            model.prefill(params, model.init_cache(2, 24, device="cpu"),
                          tokens)
        else:
            model.forward(params, tokens)
    dims = (256, 256) if arch == "paligemma-3b" else (192, 128)
    assert seen == [(dims, torch.bfloat16, "wgmma")] * cfg.n_layers


@pytest.mark.parametrize("captured", [False, True])
def test_dispatch_records_the_variant_and_counts_per_variant(captured):
    """``record`` sets a site's path and variant; one ``count_launch``
    both counts the launch, per variant too, and records the "cuda" path
    with that variant, and inside ``capturing()`` it tallies the launch
    instead of counting it."""
    site = f"variant-test-site-{captured}"
    dispatch.record(site, "cuda", "wgmma")
    assert dispatch.status(site) == {"path": "cuda", "variant": "wgmma"}
    dispatch.record(site, "torch")
    assert dispatch.status(site) == {"path": "torch"}
    before = dispatch.launches(site)
    with (dispatch.capturing() if captured
          else contextlib.nullcontext()) as tally:
        for variant in ("wgmma", "wgmma", "fp32"):
            dispatch.count_launch(site, variant)
            assert dispatch.status(site) == {"path": "cuda",
                                             "variant": variant}
    if captured:
        assert dispatch.launches(site) == before
        assert tally.counts == {(site, "wgmma"): 2, (site, "fp32"): 1}
    else:
        assert dispatch.launches(site) == before + 3
        got = dispatch.variant_launches(site)
        assert got["wgmma"] >= 2 and got["fp32"] >= 1
    dispatch.count_launch(site)
    assert dispatch.status(site) == {"path": "cuda"}


# ------------------------------------------------ bf16-P rounding bound
def _bf16_values(rng, shape) -> torch.Tensor:
    """Normals rounded to bfloat16, held in float32."""
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return x.to(torch.bfloat16).float()


def _tiled_bf16_p(q, k, v, *, causal: bool, bk: int = 64,
                  round_p: bool = True) -> torch.Tensor:
    """The wgmma variant's arithmetic on plain ops: over key tiles of
    ``bk``, float32 scores, a running max m, l summed from the float32
    probabilities 2^(x - m) relative to m, and P rounded to bfloat16
    (``round_p``) before it multiplies V; q (B, S, H, D) against k
    (B, S, KV, D) and v (B, S, KV, Dv), query head h on KV head
    h // (H // KV) -> float32 out (B, S, H, Dv)."""
    B, S, H, D = q.shape
    scale = D ** -0.5
    g = H // k.shape[2]
    k, v = (torch.repeat_interleave(t, g, dim=2) for t in (k, v))
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))    # (B, H, S, X)
    m = torch.full((B, H, S, 1), kf.NEG_INF)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, v.shape[-1]))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        cols = torch.arange(k0, min(S, k0 + bk))[None, :]
        s = torch.matmul(qh, kh[:, :, k0:k0 + bk].transpose(-1, -2)) * scale
        ok = (cols <= rows) if causal else torch.ones_like(cols <= rows)
        s = torch.where(ok, s, kf.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new), 0.0)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        pv = p.to(torch.bfloat16).float() if round_p else p
        acc = acc * corr + torch.matmul(pv, vh[:, :, k0:k0 + bk])
        m = m_new
    return (acc / l).transpose(1, 2)


@pytest.mark.parametrize("H,KV,D,Dv", [
    (16, 16, 128, 128),     # olmo-1b
    (8, 1, 256, 256),       # paligemma-3b
    (16, 16, 192, 128),     # deepseek-v2-lite-16b's MLA
])
@pytest.mark.parametrize("S,causal", [(192, True), (200, True),
                                      (130, False)])
def test_bf16_p_rounding_stays_inside_its_bound(S, causal, H, KV, D, Dv):
    """At the head widths of the wgmma variant's models on a short S:
    rounding P to bfloat16 per key tile, relative to the running max as
    the kernel does, moves the output by no more than ``bf16_p_bound``,
    and by something (the term is not vacuous)."""
    rng = np.random.default_rng(S)
    q = _bf16_values(rng, (1, S, H, D))
    k = _bf16_values(rng, (1, S, KV, D))
    v = _bf16_values(rng, (1, S, KV, Dv))
    want, _ = kf.flash_attention_forward_plain(q, k, v, causal=causal)
    exact = _tiled_bf16_p(q, k, v, causal=causal, round_p=False)
    torch.testing.assert_close(exact, want, atol=1e-5, rtol=0)
    got = _tiled_bf16_p(q, k, v, causal=causal)
    bound = kf.bf16_p_bound(q, k, v, causal=causal)
    diff = (got - want).abs()
    assert bound.shape == want.shape
    assert bool((diff <= bound).all())
    assert float(diff.max()) > 0.0
    # the bound is twice the worst case of the rounding, not a loose cap
    assert float((diff / bound).max()) <= 0.5


@pytest.mark.parametrize("D,Dv", [(192, 128), (256, 256)])
def test_tiled_bf16_p_matches_the_jax_kernel(D, Dv):
    """The mirror of the wgmma variant at the head dims it gained, against
    the JAX Pallas kernel in interpret mode (one head, the reference's
    (B, S, D) layout, its 64-row blocks): with P kept in float32 within
    1e-5 (float32 sums in another order), and with P rounded to bfloat16
    within ``bf16_p_bound`` of it."""
    rng = np.random.default_rng(D + Dv)
    S = 192
    q, k = (_bf16_values(rng, (2, S, 1, D)) for _ in range(2))
    v = _bf16_values(rng, (2, S, 1, Dv))
    want = np.asarray(jops.flash_attention(
        *(jnp.asarray(t[:, :, 0].numpy()) for t in (q, k, v)), causal=True,
        bq=64, bk=64))
    exact = _tiled_bf16_p(q, k, v, causal=True, round_p=False)[:, :, 0]
    np.testing.assert_allclose(exact.numpy(), want, atol=1e-5, rtol=0)
    got = _tiled_bf16_p(q, k, v, causal=True)[:, :, 0]
    bound = kf.bf16_p_bound(q, k, v, causal=True)[:, :, 0]
    assert bool(((got - torch.tensor(want)).abs() <= bound + 1e-5).all())


def test_bf16_p_bound_of_a_single_key_is_its_value():
    """One visible key: p = 1, so the bound is 2^-7 |v| for that row."""
    rng = np.random.default_rng(0)
    q, k, v = (_bf16_values(rng, (1, 3, 2, 64)) for _ in range(3))
    bound = kf.bf16_p_bound(q, k, v, causal=True)
    torch.testing.assert_close(bound[:, 0], 2.0 ** -7 * v[:, 0].abs())


# ------------------------------------------------- decode split-KV design
@pytest.mark.parametrize("L,n", [(0, 1), (1, 1), (12, 1), (128, 1),
                                 (129, 2), (200, 2), (896, 7), (897, 8),
                                 (1016, 8), (1024, 8), (32768, 8)])
def test_decode_splits(L, n):
    """One CTA per 128 slots, 1 for short caches, at most 8 (the portable
    cluster size); a function of L alone."""
    assert kf.decode_splits(L) == n


@pytest.mark.parametrize("L", [1, 7, 129, 1001, 1016, 4097])
def test_split_ranges_cover_the_cache_in_order(L):
    n = kf.decode_splits(L)
    ranges = kf.split_ranges(L, n)
    assert len(ranges) == n and ranges[0][0] == 0 and ranges[-1][1] == L
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(j1 - j0 == -(-L // n) for j0, j1 in ranges[:-1])


def _decode_inputs(rng, B, L, D, Dv):
    q = rng.standard_normal((B, D), dtype=np.float32)
    k = rng.standard_normal((B, L, D), dtype=np.float32)
    v = rng.standard_normal((B, L, Dv), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("L,n_split,masked", [
    (1001, 8, []),            # L not divisible by n_split
    (200, 3, [1]),            # a split with no valid slot
    (1016, None, [0, 5, 7]),  # decode_splits' count, three empty splits
    (129, None, [1]),         # the last split empty
])
def test_split_mirror_matches_plain(L, n_split, masked):
    rng = np.random.default_rng(L)
    q, k, v = (torch.from_numpy(a) for a in _decode_inputs(rng, 3, L, 32,
                                                             16))
    valid = torch.from_numpy(rng.random(L) < 0.6)
    n = kf.decode_splits(L) if n_split is None else n_split
    ranges = kf.split_ranges(L, n)
    for r in masked:
        valid[ranges[r][0]:ranges[r][1]] = False
    m, l, acc = kf.decode_partials_plain(q, k, v, valid, n)
    for r in masked:
        assert bool((m[r] == kf.NEG_INF).all()) and bool((l[r] == 0).all())
        assert bool((acc[r] == 0).all())
    want = kf.flash_decode_plain(q, k, v, valid)
    got = kf.flash_decode_split_plain(q, k, v, valid, n_split=n_split)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_split_mirror_matches_the_jax_kernel():
    rng = np.random.default_rng(11)
    L = 1001
    q, k, v = _decode_inputs(rng, 4, L, 32, 32)
    valid = rng.random(L) < 0.6
    valid[126:252] = False                       # split 1 of 8 empty
    want = np.asarray(jops.flash_decode(q, k, v, jnp.asarray(valid), bk=7))
    got = kf.flash_decode_split_plain(*(torch.from_numpy(a)
                                        for a in (q, k, v, valid)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_split_mirror_row_without_a_valid_slot_is_zero():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(a) for a in _decode_inputs(rng, 2, 300, 16,
                                                             16))
    none = torch.zeros(300, dtype=torch.bool)
    got = kf.flash_decode_split_plain(q, k, v, none)
    assert bool((got == 0).all())
    assert torch.equal(got, kf.flash_decode_plain(q, k, v, none))


def test_merge_gives_an_empty_split_no_weight():
    """A split with l = 0 (its m is NEG_INF) is left out of the merge
    whatever its acc holds: with every split empty, exp(m - max) would be
    exp(0) = 1."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(a) for a in _decode_inputs(rng, 2, 256, 16,
                                                             16))
    valid = torch.ones(256, dtype=torch.bool)
    valid[128:] = False
    m, l, acc = kf.decode_partials_plain(q, k, v, valid, 2)
    want = kf.merge_partials_plain(m, l, acc)
    acc[1] = 123.0                                # garbage in the empty one
    torch.testing.assert_close(kf.merge_partials_plain(m, l, acc), want,
                               atol=0, rtol=0)
    m[:], l[:] = kf.NEG_INF, 0.0                  # every split empty
    assert bool((kf.merge_partials_plain(m, l, acc) == 0).all())


@pytest.mark.parametrize("H,KV", [(4, 2), (16, 16)])
def test_split_mirror_matches_plain_on_the_cache_layout(H, KV):
    """The serving cache's (B, L, KV, D) layout, query head h on KV head
    h // (H // KV): the mirror on the folded rows equals
    ``flash_decode_gqa_plain``."""
    rng = np.random.default_rng(H + KV)
    B, L, D = 2, 1016, 32
    q = torch.from_numpy(rng.standard_normal((B, H, D), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, L, KV, D),
                                                 dtype=np.float32))
            for _ in range(2))
    valid = torch.from_numpy(rng.random(L) < 0.6)
    valid[254:381] = False                        # split 2 of 8 empty
    fold = lambda t: torch.repeat_interleave(t, H // KV, dim=2).transpose(
        1, 2).reshape(B * H, L, D)
    got = kf.flash_decode_split_plain(q.reshape(B * H, D), fold(k), fold(v),
                                      valid)
    want = kf.flash_decode_gqa_plain(q, k, v, valid)
    torch.testing.assert_close(got.reshape(B, H, D), want, atol=1e-6,
                               rtol=0)
