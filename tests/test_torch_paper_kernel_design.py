"""The design of the paper path's two kernels, checked on the CPU through
the plain mirrors beside their plain versions: mandelbrot's grouped
escape test with its replay, its strided tiles, and spin_image's split
of the cloud over a cluster's CTAs and its guarded fast binning.

Tolerances, each with its reason:
  * mandelbrot: exact.  The replay mirror runs the same rounded
    operations in the same order as the plain version, and a strided view
    holds the same values as its contiguous copy.  Against the JAX
    package on a shared grid: exact, as in test_torch_parity_apps.py.
  * spin_image: exact between the port's versions.  The split sums
    integer counts, and the guard keeps an approximate bin only where no
    integer lies within EPS of the coordinate.  Against the JAX package
    (interpret mode): no point lost and at most 1 in 10^4 of the binned
    points moved, the bound of test_torch_parity_apps.py, since the JAX
    package sums beta and |x - c|^2 in its own order.
"""

import numpy as np
import pytest
import torch

from repro.apps import mandelbrot as jm
from repro.apps import psia as jp
from repro.kernels import ops as jops
from repro_torch.apps import mandelbrot as tm
from repro_torch.kernels import mandelbrot as km
from repro_torch.kernels import spin_image as ks

KW = dict(n_alpha=64, n_beta=64, alpha_max=3.0, beta_max=3.0)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


EDGES, ORIGIN, UP = ks.bin_edge_cloud(**KW)


# ------------------------------------------------------- spin_image split
@pytest.mark.parametrize("n_centers,want", [
    (1, 8), (2, 8), (20, 8), (39, 8), (132, 2), (157, 2), (2048, 1),
    (2500, 1)])
def test_pt_split_at_the_runs_chunks(n_centers, want):
    assert ks.pt_split(n_centers, 16_384) == want


@pytest.mark.parametrize("n_points,want", [
    (0, 1), (512, 1), (2047, 1), (2048, 2), (4095, 2), (4096, 4),
    (16_383, 8)])
def test_pt_split_keeps_enough_points_per_cta(n_points, want):
    split = ks.pt_split(1, n_points)
    assert split == want
    assert split == 1 or n_points // split >= ks.MIN_POINTS
    assert split & (split - 1) == 0 and split <= ks.MAX_SPLIT


@pytest.mark.parametrize("n_points,split", [
    (16_384, 8), (16_383, 8), (16_383, 2), (16_384, 1), (13, 4), (3, 8),
    (0, 2), (1000, 3)])
def test_pt_ranges_cover_the_cloud_in_order(n_points, split):
    ranges = ks.pt_ranges(n_points, split)
    assert len(ranges) == split
    assert ranges[0][0] == 0 and ranges[-1][1] == n_points
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0                        # contiguous, in rank order
    full = [p1 - p0 for p0, p1 in ranges if p1 > p0]
    # equal ranges of a multiple of 4 points (the kernel's float4 reads),
    # then one ragged range, then empty ranges at the end of the cloud
    assert all(n == full[0] and n % 4 == 0 for n in full[:-1])
    assert not full or 0 < full[-1] <= full[0]
    assert all(p0 == n_points for p0, p1 in ranges[len(full):])


@pytest.mark.parametrize("bo,cloud_n", [(3, 4096), (5, 4093)])
def test_split_mirror_equals_plain_and_jax(bo, cloud_n):
    pts = np.asarray(jp.cloud(cloud_n))
    ctr, nrm = (np.asarray(a) for a in jp.oriented_points(bo))
    p, c, n = _t(pts), _t(ctr), _t(nrm)
    plain = ks.spin_image_plain(p, c, n, **KW)
    for split in (1, 2, 4, 8):
        assert torch.equal(
            ks.spin_image_split_mirror(p, c, n, split=split, **KW), plain)
    want = np.asarray(jops.spin_image(pts, ctr, nrm, block_p=256, **KW))
    got = ks.spin_image_split_mirror(p, c, n, split=ks.pt_split(
        bo, cloud_n), **KW).numpy()
    assert got.sum() == want.sum()                        # nothing lost
    assert np.abs(got - want).sum() / 2 <= 1e-4 * want.sum()


# -------------------------------------------------- spin_image fast path
def _rsqrt_off_by(ulps: int):
    """float32 rsqrt moved ``ulps`` units in the last place (within the
    2 ulp the card's rsqrtf may be off)."""
    def rsqrt(x):
        y = torch.rsqrt(x.double()).to(torch.float32)
        toward = torch.full_like(y, np.inf if ulps > 0 else -np.inf)
        for _ in range(abs(ulps)):
            y = torch.nextafter(y, toward)
        return y
    return rsqrt


@pytest.mark.parametrize("ulps", [-2, -1, 0, 1, 2])
def test_guard_mirror_on_bin_edges_equals_plain(ulps):
    pts = EDGES
    plain = ks.spin_image_plain(pts, ORIGIN, UP, **KW)
    got, slow = ks.spin_image_guard_mirror(pts, ORIGIN, UP,
                                           rsqrt=_rsqrt_off_by(ulps), **KW)
    assert torch.equal(got, plain)
    # every point exactly on an edge or a range end takes the exact chain
    assert slow >= pts.shape[0] // 3


def test_guard_is_what_keeps_edge_points_in_their_bins(monkeypatch):
    """Without its margin, a 2-ulp-low rsqrt moves the points that lie
    on an alpha edge into the bin below: the guard is what the test
    above checks."""
    pts = EDGES
    plain = ks.spin_image_plain(pts, ORIGIN, UP, **KW)
    monkeypatch.setattr(ks, "EPS", 0.0)
    got, _ = ks.spin_image_guard_mirror(pts, ORIGIN, UP,
                                        rsqrt=_rsqrt_off_by(-2), **KW)
    assert not torch.equal(got, plain)


def test_guard_mirror_on_the_paper_data_is_exact_and_rarely_slow():
    pts = np.asarray(jp.cloud(4096))
    ctr, nrm = (np.asarray(a) for a in jp.oriented_points(16))
    p, c, n = _t(pts), _t(ctr), _t(nrm)
    got, slow = ks.spin_image_guard_mirror(p, c, n, **KW)
    assert torch.equal(got, ks.spin_image_plain(p, c, n, **KW))
    assert slow <= 1e-3 * 16 * 4096


# ------------------------------------------------------------ mandelbrot
def _special_grid() -> tuple[torch.Tensor, torch.Tensor]:
    """The classic view at 48 x 40, with a row of values that escape at
    once, overflow or are not numbers."""
    cr, ci = (a[8:56, 4:44].clone() for a in tm.grid(64, device="cpu"))
    cr[0, :6] = torch.tensor([np.nan, np.inf, -np.inf, 1e30, -2.3, 0.0])
    ci[0, :6] = torch.tensor([0.0, 0.0, 1.0, 1e30, 0.0, np.nan])
    return cr, ci


@pytest.mark.parametrize("max_iters", [0, 1, 7, 8, 13, 64])
def test_replay_mirror_equals_plain(max_iters):
    cr, ci = _special_grid()
    want = km.mandelbrot_plain(cr, ci, max_iters)
    assert torch.equal(km.mandelbrot_replay_mirror(cr, ci, max_iters),
                       want)
    assert torch.equal(km.mandelbrot_replay_mirror(cr, ci, max_iters,
                                                   group=3), want)


def test_mandelbrot_on_a_strided_view_equals_its_copy():
    cr, ci = tm.grid(128, device="cpu")
    a, b = cr[32:64, 64:96], ci[32:64, 64:96]
    assert not a.is_contiguous()
    got = km.mandelbrot(a, b, max_iters=64)
    assert got.is_contiguous() and got.dtype == torch.int32
    assert torch.equal(got, km.mandelbrot(a.contiguous(), b.contiguous(),
                                          max_iters=64))


@pytest.mark.parametrize("tile_id", [0, 5, 10])
def test_tile_views_equal_jax_tiles_on_a_shared_grid(tile_id):
    side, tile, iters = 128, 32, 64
    jcr, jci = (np.asarray(a) for a in jm.grid(side))
    ty, tx = divmod(tile_id, side // tile)
    sl = (slice(ty * tile, (ty + 1) * tile),
          slice(tx * tile, (tx + 1) * tile))
    want = np.asarray(jops.mandelbrot(jcr[sl], jci[sl], max_iters=iters))
    got = km.mandelbrot(_t(jcr)[sl], _t(jci)[sl], max_iters=iters).numpy()
    np.testing.assert_array_equal(got, want)
    own = tm.compute_tile(tile_id, side=side, tile=tile, max_iters=iters,
                          device="cpu")
    np.testing.assert_array_equal(
        own, tm.escape_counts(side, iters, device="cpu")[sl])
    jax_tile = jm.compute_tile(tile_id, side=side, tile=tile,
                               max_iters=iters)
    assert (own != jax_tile).sum() <= 4        # the grids' own bound


@pytest.mark.parametrize("bad", ["column_stride", "row_strides"])
def test_mandelbrot_rejects_other_strides(bad):
    base = torch.zeros(8, 16)
    if bad == "column_stride":
        a, b = base[:, ::2], torch.zeros(8, 8)
    else:
        a, b = base[:, :8], torch.zeros(8, 8)
    with pytest.raises(ValueError):
        km.mandelbrot(a, b, max_iters=4)
