"""The CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with ``nvcc`` (sm_90a): they are marked
``cuda`` and skip elsewhere.  On the card, run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: none for mandelbrot and spin_image, whose kernels round
every operation as their plain versions do.  The decode kernels sum in
another order than the plain versions' library reductions: float32
attention within 1e-5, bfloat16 attention within one rounding of the
output (1e-4 + 2**-7 of its size), wkv6 within 1e-5 (one step) and 1e-4
(chunked) of the output's scale.
"""

import numpy as np
import pytest
import torch

from repro_torch.apps import mandelbrot, psia
from repro_torch.kernels import dispatch
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import mandelbrot as km
from repro_torch.kernels import rwkv6_scan as kw
from repro_torch.kernels import spin_image as ks

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("m,n,max_iters", [(128, 128, 64), (96, 80, 64),
                                           (17, 300, 256)])
def test_mandelbrot_kernel_equals_plain(cuda, m, n, max_iters):
    rng = np.random.default_rng(m * n)
    cr = torch.from_numpy(rng.uniform(-2.0, 0.6, (m, n)).astype(np.float32))
    ci = torch.from_numpy(rng.uniform(-1.3, 1.3, (m, n)).astype(np.float32))
    cr, ci = cr.to(cuda), ci.to(cuda)
    before = dispatch.launches("mandelbrot")
    got = km.mandelbrot(cr, ci, max_iters=max_iters)
    torch.cuda.synchronize()
    assert dispatch.launches("mandelbrot") == before + 1
    assert dispatch.status("mandelbrot")["path"] == "cuda"
    want = km.mandelbrot_plain(cr, ci, max_iters)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bo,n_alpha,n_beta", [(64, 64, 64), (33, 32, 16),
                                               (8, 128, 128)])
def test_spin_image_kernel_equals_plain(cuda, bo, n_alpha, n_beta):
    data = psia.dataset(n=bo, cloud_n=4096, device=cuda)
    kw = dict(n_alpha=n_alpha, n_beta=n_beta, alpha_max=3.0, beta_max=3.0)
    got = ks.spin_image(data.points, data.centers, data.normals, **kw)
    torch.cuda.synchronize()
    want = ks.spin_image_plain(data.points, data.centers, data.normals,
                               **kw)
    assert torch.equal(got, want)


def test_cuda_tile_equals_cpu_tile(cuda):
    got = mandelbrot.compute_tile(5, side=128, tile=32, max_iters=64)
    want = mandelbrot.compute_tile(5, side=128, tile=32, max_iters=64,
                                   device="cpu")
    np.testing.assert_array_equal(got, want)


def _mask(L, bk, gen):
    valid = torch.rand(L, generator=gen) < 0.6
    valid[bk:2 * bk] = False                # one fully masked block
    valid[0] = True
    return valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [12, 200, 1016])
def test_flash_decode_kernel_equals_plain(cuda, L, dtype):
    gen = torch.Generator().manual_seed(L)
    B, D = 8, 128
    q, k, v = (torch.randn(s, generator=gen).to(cuda, dtype)
               for s in ((B, D), (B, L, D), (B, L, D)))
    valid = _mask(L, 4, gen).to(cuda)
    before = dispatch.launches("flash_decode")
    got = kf.flash_decode(q, k, v, valid)
    torch.cuda.synchronize()
    assert dispatch.launches("flash_decode") == before + 1
    assert got.dtype == dtype
    want = kf.flash_decode_plain(q, k, v, valid)
    atol, rtol = (1e-5, 0.0) if dtype == torch.float32 else (1e-4, 2.0 ** -7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("H,KV,D", [(16, 16, 128), (8, 2, 64), (4, 1, 256)])
def test_flash_decode_gqa_kernel_equals_plain(cuda, H, KV, D):
    gen = torch.Generator().manual_seed(H * KV)
    B, L = 3, 77
    q = torch.randn((B, H, D), generator=gen).to(cuda)
    k, v = (torch.randn((B, L, KV, D), generator=gen).to(cuda)
            for _ in range(2))
    valid = _mask(L, 8, gen).to(cuda)
    got = kf.flash_decode_gqa(q, k, v, valid)
    want = kf.flash_decode_gqa_plain(q, k, v, valid)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    none = torch.zeros(L, dtype=torch.bool, device=cuda)
    assert torch.equal(kf.flash_decode_gqa(q, k, v, none),
                       torch.zeros_like(got))


def _wkv(cuda, BH, T, dk, dtype, gen):
    lead = (BH, T) if T else (BH,)
    r, k, v = (torch.randn(lead + (dk,), generator=gen) for _ in range(3))
    w = torch.rand(lead + (dk,), generator=gen) * 0.9 + 0.05
    u = torch.randn((BH, dk), generator=gen)
    s = torch.randn((BH, dk, dk), generator=gen)
    return ([t.to(cuda, dtype) for t in (r, k, v, w, u)]
            + [s.to(cuda)])


def _close_scaled(got, want, rel):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=rel * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_decode_kernel_equals_plain(cuda, dtype):
    ins = _wkv(cuda, 256, 0, 64, dtype, torch.Generator().manual_seed(1))
    y, s = kw.wkv6_decode(*ins)
    want_y, want_s = kw.wkv6_decode_plain(*ins)
    _close_scaled(y, want_y, 1e-5)
    _close_scaled(s, want_s, 1e-5)
    state = ins[5].clone()                   # in place, as decode uses it
    y2, out = kw.wkv6_decode(*ins[:5], state, out_state=state)
    assert out is state
    assert torch.equal(y2, y) and torch.equal(state, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [64, 37, 1])
def test_wkv6_batched_kernel_equals_plain(cuda, T, dtype):
    ins = _wkv(cuda, 64, T, 64, dtype, torch.Generator().manual_seed(T))
    y, s = kw.wkv6_batched(*ins)
    torch.cuda.synchronize()
    want_y, want_s = kw.wkv6_batched_plain(*ins)
    _close_scaled(y, want_y, 1e-4)
    _close_scaled(s, want_s, 1e-4)
