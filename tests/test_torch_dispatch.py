"""The port's kernel telemetry: path records and launch counts."""

import sys
import threading

import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import moe
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as kw
from repro_torch.kernels import spin_image as ks


def test_launch_count_survives_thread_races():
    """Worker threads of the threaded engine count launches concurrently:
    no increment may be lost."""
    site, n_threads, per_thread = "stress-test-site", 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [dispatch.count_launch(site)
                            for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert dispatch.launches(site) == n_threads * per_thread


def test_cpu_path_records_torch_and_counts_no_launch():
    before = dispatch.launches("mandelbrot")
    ops.mandelbrot(torch.zeros(4, 4), torch.zeros(4, 4), max_iters=3)
    assert dispatch.status("mandelbrot") == {"path": "torch"}
    assert dispatch.launches("mandelbrot") == before
    with pytest.raises(ValueError):
        dispatch.record("mandelbrot", "jnp-fallback")


def _r(*shape):
    return torch.rand(shape)


#: each kernel wrapper: (the sites it records, a call on CPU tensors at a
#: tiny size)
WRAPPERS = {
    "mandelbrot": (("mandelbrot",), lambda: ops.mandelbrot(
        _r(4, 4), _r(4, 4), max_iters=3)),
    "spin_image": (("spin_image",), lambda: ks.spin_image(
        _r(8, 3), _r(2, 3), _r(2, 3), n_alpha=4, n_beta=4)),
    "flash_decode": (("flash_decode",), lambda: kf.flash_decode(
        _r(2, 8), _r(2, 5, 8), _r(2, 5, 8), torch.ones(5, dtype=torch.bool))),
    "flash_decode_gqa": (("flash_decode",), lambda: kf.flash_decode_gqa(
        _r(2, 4, 8), _r(2, 5, 2, 8), _r(2, 5, 2, 8),
        torch.ones(5, dtype=torch.bool))),
    "flash_attention_forward": (("flash_attention",),
                                lambda: kf.flash_attention_forward(
        _r(1, 6, 4, 8), _r(1, 6, 2, 8), _r(1, 6, 2, 8))),
    "wkv6_decode": (("wkv6_decode",), lambda: kw.wkv6_decode(
        _r(2, 4), _r(2, 4), _r(2, 4), _r(2, 4), _r(2, 4), _r(2, 4, 4))),
    "wkv6_batched": (("wkv6_batched",), lambda: kw.wkv6_batched(
        _r(2, 5, 4), _r(2, 5, 4), _r(2, 5, 4), _r(2, 5, 4), _r(2, 4),
        _r(2, 4, 4))),
    "routed_experts": (("moe_route", "moe_gemm"), lambda: moe.routed_experts(
        _r(3, 16), _r(3, 4), _r(4, 16, 8), _r(4, 16, 8), _r(4, 8, 16),
        top_k=2, norm_topk=True, scale=1.0,
        counter=torch.zeros(4, dtype=torch.int64))),
}
SITES = sorted({s for sites, _ in WRAPPERS.values() for s in sites})


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_every_wrapper_on_the_cpu_records_torch_and_counts_nothing(
        name, monkeypatch):
    """Each kernel wrapper on CPU tensors runs its plain version: it
    records the "torch" path of its own sites, counts no launch, and
    leaves every other site's record as it was."""
    sites, call = WRAPPERS[name]
    earlier = {"path": "cuda", "variant": "earlier"}
    monkeypatch.setattr(dispatch, "_STATUS",
                        {s: dict(earlier) for s in SITES})
    launches = dispatch.launches()
    variants = {s: dispatch.variant_launches(s) for s in SITES}
    call()
    for s in SITES:
        assert dispatch.status(s) == ({"path": "torch"} if s in sites
                                      else earlier), s
    assert dispatch.launches() == launches
    assert {s: dispatch.variant_launches(s) for s in SITES} == variants
