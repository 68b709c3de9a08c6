"""PyTorch/CUDA port of the rDLB reproduction (the JAX package ``repro``
is the reference).

The scheduling stack (``core``, ``api``) is a copy of the reference's,
held against it by parity tests; the applications (``apps``) run on an
NVIDIA GPU through hand-written CUDA kernels (``kernels``, sources in
``csrc/``).  Entry points run on the card unless the caller passes
``device="cpu"``, which selects the kernels' plain PyTorch versions.
This package imports neither ``jax`` nor anything of ``repro``.
"""
