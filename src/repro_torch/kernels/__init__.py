"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``).

mandelbrot        escape-time iteration (the paper's high-variance app)
spin_image        PSIA spin-image histograms in shared memory
flash_attention   single-query attention over a KV cache (flash_decode)
rwkv6_scan        WKV6 recurrence: one decode step, chunked prefill

Each kernel module holds the wrapper that launches the kernel on CUDA
tensors, and its plain PyTorch version, which CPU tensors take;
``ops.py`` re-exports the wrappers and ``ref.py`` the plain versions.
``_build.py`` compiles the sources at first use, never at import.
"""

from repro_torch.kernels import ops, ref  # noqa: F401
