"""The CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with ``nvcc`` (sm_90a): they are marked
``cuda`` and skip elsewhere.  On the card, run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: none.  Kernel and plain version round every operation in the
same order, so they agree exactly.
"""

import numpy as np
import pytest
import torch

from repro_torch.apps import mandelbrot, psia
from repro_torch.kernels import dispatch
from repro_torch.kernels import mandelbrot as km
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
