"""The design of the Hopper RWKV6 kernels (``csrc/wkv6.cu``), on the CPU:
the split of a row's state columns over CTAs (``col_split``,
``col_ranges``), the decode kernel's y summed in row groups of
``ROW_GROUP`` rows, and the prefill cluster's partition of each chunk's
matrix A (``pair_ranges``), through the plain mirrors in
``kernels/rwkv6_scan.py`` that follow the kernels' decomposition.

Tolerances: the mirrors against ``wkv6_decode_plain`` and
``wkv6_batched_plain`` within 1e-6 of the output's largest magnitude
(float32: the same terms summed in another order).  Against the JAX
package as ``tests/test_torch_decode_kernels.py`` holds the plain
versions: the sequential ``ref.wkv6`` within 1e-4 (the chunked form goes
through exp/log of the decays) and the chunked Pallas kernel in interpret
mode within 1e-3 (it scales k by exp(-cumsum log w) and loses digits).
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import rwkv6_scan as kw


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _inputs(rng, BH, T, dk, dv, w):
    """r, k, v, w, u, state (numpy float32); T = 0 gives one step's."""
    shp = (BH, T, dk) if T else (BH, dk)
    r, k = (rng.standard_normal(shp, dtype=np.float32) for _ in range(2))
    v = rng.standard_normal(shp[:-1] + (dv,), dtype=np.float32)
    ww = (rng.uniform(0.1, 1.0, shp).astype(np.float32) if w == "uniform"
          else np.full(shp, w, np.float32))
    u = rng.standard_normal((BH, dk), dtype=np.float32)
    s = rng.standard_normal((BH, dk, dv), dtype=np.float32)
    return r, k, v, ww, u, s


def _close(got, want, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(
        want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


# ------------------------------------------------------------ column split
@pytest.mark.parametrize("BH,dv,n", [
    (1, 64, 8), (32, 64, 8), (256, 64, 2), (2048, 64, 1), (132, 64, 2),
    (264, 64, 1), (32, 8, 1), (6, 16, 2), (3, 12, 1), (1, 128, 8),
    (64, 128, 8), (200, 128, 2)])
def test_col_split(BH, dv, n):
    """Doubled while BH x n_col < 2 x 132 SMs, at least 8 columns a CTA,
    n_col divides dv, at most 8 (a portable cluster): rwkv6-1.6b's heads
    get 8 CTAs at BH = 32 (the serving path), 2 at 256, 1 at 2048."""
    assert kw.col_split(BH, dv) == n


@pytest.mark.parametrize("dv", [8, 12, 16, 64, 96, 128, 256])
def test_col_split_rules_over_bh(dv):
    for BH in range(1, 600):
        n = kw.col_split(BH, dv)
        assert 1 <= n <= kw.MAX_COLS_SPLIT and dv % n == 0
        assert n == 1 or dv // n >= kw.MIN_COLS
        # it stops doubling only at the target or at a limit
        assert (BH * n >= kw.TARGET_CTAS or 2 * n > kw.MAX_COLS_SPLIT
                or dv % (2 * n) or dv // (2 * n) < kw.MIN_COLS)


@pytest.mark.parametrize("dv,n_col", [(64, 8), (64, 2), (64, 1), (16, 2)])
def test_col_ranges_cover_the_columns_in_order(dv, n_col):
    ranges = kw.col_ranges(dv, n_col)
    assert len(ranges) == n_col and ranges[0][0] == 0
    assert ranges[-1][1] == dv
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert len({j1 - j0 for j0, j1 in ranges}) == 1


# ------------------------------------------------------- decode split mirror
@pytest.mark.parametrize("BH,dk,dv", [(32, 64, 64), (256, 64, 64),
                                      (6, 16, 16), (3, 10, 8)])
def test_decode_split_mirror_matches_plain(BH, dk, dv):
    rng = np.random.default_rng(BH + dk)
    ins = [_t(a) for a in _inputs(rng, BH, 0, dk, dv, "uniform")]
    y, s = kw.wkv6_decode_split_plain(*ins)
    want_y, want_s = kw.wkv6_decode_plain(*ins)
    _close(y, want_y, 1e-6)
    _close(s, want_s, 1e-6)


def test_decode_result_does_not_depend_on_the_split():
    """y sums fixed groups of ROW_GROUP rows in group order whatever the
    split, so a row gives the same bits at any n_col (and so in a group of
    any size)."""
    rng = np.random.default_rng(7)
    ins = [_t(a) for a in _inputs(rng, 4, 0, 64, 64, "uniform")]
    base = kw.wkv6_decode_split_plain(*ins, n_col=1)
    for n_col in (2, 4, 8):
        got = kw.wkv6_decode_split_plain(*ins, n_col=n_col)
        assert all(torch.equal(a, b) for a, b in zip(got, base))


def test_decode_row_groups_sum_in_order():
    """dk = 10: groups of rows 0-3, 4-7, 8-9; y is the partials' sum in
    group order, each partial its rows' terms in row order."""
    rng = np.random.default_rng(3)
    r, k, v, w, u, s = (_t(a) for a in _inputs(rng, 2, 0, 10, 8,
                                                "uniform"))
    y, _ = kw.wkv6_decode_split_plain(r, k, v, w, u, s, n_col=1)
    terms = r[:, :, None] * (s + u[:, :, None] * (k[:, :, None]
                                                  * v[:, None, :]))
    parts = [terms[:, 0] + terms[:, 1] + terms[:, 2] + terms[:, 3],
             terms[:, 4] + terms[:, 5] + terms[:, 6] + terms[:, 7],
             terms[:, 8] + terms[:, 9]]
    assert torch.equal(y, parts[0] + parts[1] + parts[2])


def test_decode_mirror_matches_jax():
    rng = np.random.default_rng(11)
    r, k, v, w, u, s = _inputs(rng, 32, 0, 16, 16, "uniform")
    y_k, s_k = jops.wkv6_decode(r, k, v, w, u, s)
    y, st = kw.wkv6_decode_split_plain(*map(_t, (r, k, v, w, u, s)))
    assert kw.col_split(32, 16) == 2
    _close(y, y_k, 1e-5)
    _close(st, s_k, 1e-5)


# ------------------------------------------------ batched: A's partition
@pytest.mark.parametrize("c", [1, 2, 5, 31, 32])
@pytest.mark.parametrize("n_col", [1, 2, 3, 8])
def test_pair_ranges_cover_the_lower_triangle_once(c, n_col):
    """The ranks' pairs (t, s <= t) together are the lower triangle with
    its diagonal, each pair exactly once, in shares that differ by at most
    one rank's worth (the last ones shorter)."""
    ranges = kw.pair_ranges(c, n_col)
    assert len(ranges) == n_col
    pairs = [kw.pair_of(p) for p0, p1 in ranges for p in range(p0, p1)]
    assert sorted(pairs) == [(t, s) for t in range(c) for s in range(t + 1)]
    assert len(set(pairs)) == len(pairs)
    per = -(-c * (c + 1) // 2 // n_col)
    assert all(p1 - p0 <= per for p0, p1 in ranges)


def test_pair_of_numbers_pairs_row_by_row():
    p = 0
    for t in range(40):
        for s in range(t + 1):
            assert kw.pair_of(p) == (t, s)
            p += 1


def test_pairwise_shares_give_the_same_matrix():
    """A assembled from 1, 2 or 8 ranks' shares: every pair is computed by
    the same arithmetic, whichever rank owns it."""
    rng = np.random.default_rng(2)
    r, k, _, w, u, _ = (torch.from_numpy(a) for a in _inputs(
        rng, 3, 32, 16, 16, "uniform"))
    la = torch.cumsum(torch.log(w), dim=1)
    la_prev = torch.cat([torch.zeros_like(la[:, :1]), la[:, :-1]], 1)
    base = kw.pairwise_plain(r, k, u, la, la_prev, 1)
    for n_col in (2, 8):
        torch.testing.assert_close(
            kw.pairwise_plain(r, k, u, la, la_prev, n_col), base, rtol=0,
            atol=0)
    assert torch.equal(base, torch.tril(base))


# ---------------------------------------------------- batched split mirror
@pytest.mark.parametrize("BH,T,dk,dv,w", [
    (32, 1000, 16, 16, "uniform"),   # the serving path's split, 32 chunks
    (32, 37, 64, 64, "uniform"),     # ragged last chunk, 8 CTAs a head
    (4, 64, 16, 16, 0.01),           # strong decay
    (3, 23, 16, 8, "uniform"),       # one CTA a head
])
def test_batched_split_mirror_matches_plain(BH, T, dk, dv, w):
    rng = np.random.default_rng(T + BH)
    ins = [_t(a) for a in _inputs(rng, BH, T, dk, dv, w)]
    y, s = kw.wkv6_batched_split_plain(*ins)
    want_y, want_s = kw.wkv6_batched_plain(*ins)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    _close(y, want_y, 1e-6)
    _close(s, want_s, 1e-6)


def _sequential(r, k, v, w, u, s):
    """JAX's ``ref.wkv6`` per head -> (y (BH, T, dv), state)."""
    out = [jref.wkv6(r[b], k[b], v[b], w[b], u[b], s[b])
           for b in range(r.shape[0])]
    return (np.stack([np.asarray(y) for y, _ in out]),
            np.stack([np.asarray(st) for _, st in out]))


@pytest.mark.parametrize("T,w", [(1000, "uniform"), (37, "uniform"),
                                 (64, 0.01), (1000, 0.01)])
def test_batched_split_mirror_matches_the_jax_oracle(T, w):
    rng = np.random.default_rng(T)
    r, k, v, ww, u, s = _inputs(rng, 2, T, 16, 16, w)
    y_ref, s_ref = _sequential(r, k, v, ww, u, s)
    y, st = kw.wkv6_batched_split_plain(*map(_t, (r, k, v, ww, u, s)))
    assert kw.col_split(2, 16) == 2
    _close(y, y_ref, 1e-4)
    _close(st, s_ref, 1e-4)


@pytest.mark.parametrize("T", [64, 37])
def test_batched_split_mirror_matches_the_jax_kernel(T):
    """Against the Pallas kernel in interpret mode, with the chunk its
    caller would pick (the largest divisor of T up to 32)."""
    rng = np.random.default_rng(T + 1)
    r, k, v, ww, u, s = _inputs(rng, 4, T, 16, 16, "uniform")
    jchunk = max(c for c in range(1, 33) if T % c == 0)
    y_k, s_k = jops.wkv6_batched(r, k, v, ww, u, s, chunk=jchunk)
    y, st = kw.wkv6_batched_split_plain(*map(_t, (r, k, v, ww, u, s)))
    _close(y, y_k, 1e-3)
    _close(st, s_k, 1e-3)


def test_batched_smem_fits_at_the_served_shapes():
    """The prefill kernel's shared memory (``_batched_smem``, which the C
    launcher computes alike) stays under a CTA's limit for rwkv6-1.6b's
    heads at every split the serving path and the benchmarks use, in both
    input types; splitting only shrinks it."""
    sizes = []
    for BH in (1, 32, 256, 2048):
        n_col = kw.col_split(BH, 64)
        for itemsize in (2, 4):
            b = kw._batched_smem(64, 64, kw.CHUNK, n_col, itemsize)
            assert b <= kw.MAX_SMEM
            sizes.append((n_col, itemsize, b))
    for n, i, b in sizes:
        for n2, i2, b2 in sizes:
            if i == i2 and n2 > n:
                assert b2 < b
