"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``).

mandelbrot        escape-time iteration (the paper's high-variance app)
spin_image        PSIA spin-image histograms in shared memory
flash_attention   single-query attention over a KV cache (flash_decode),
                  full-sequence attention with its log-sum-exp
                  (flash_attention; backward in PyTorch ops)
rwkv6_scan        WKV6 recurrence: one decode step, chunked prefill
moe               dropless MoE: top-k routing and the grouped expert
                  products (wgmma, weights through TMA)

Each kernel module holds the wrapper that launches the kernel on CUDA
tensors, and its plain PyTorch version, which CPU tensors take;
``ops.py`` re-exports the CUDA wrappers and ``ref.py`` the plain
versions the reference has oracles for.  ``_build.py`` compiles the
sources at first use, never at import, and every wrapper launches its
kernels through ``_build.launch``.
"""

from repro_torch.kernels import ops, ref  # noqa: F401
