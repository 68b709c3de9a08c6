"""The port's kernel telemetry: path records and launch counts."""

import sys
import threading

import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels import ops


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
