"""CPU findings that fixed the design of the port's kernels, held as tests.

Run as a script to print the measured numbers that PERF.md quotes:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_findings.py

1. XLA on the CPU computes the JAX Mandelbrot's imaginary update as one
   fused multiply-add, and rounds everything else on its own: only that
   variant of the loop reproduces the JAX image.
2. XLA's compiled ``jnp.linspace`` rounds in its own way: no eager
   formula reproduces the JAX grid's bits, so the port's grid gets a
   stated bound.
3. Spin images are bounded, not exact, even inside the JAX package: at
   the paper's cloud size a few points on bin edges move.
"""

import numpy as np
import torch

from repro.apps import mandelbrot as jm
from repro.apps import psia as jp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.apps import mandelbrot as tm
from repro_torch.apps import psia as tp

# ----------------------------------------------------------- finding 1
VARIANTS = ("no_fma", "fma_imag", "fma_real", "fma_both")


def _fl(x: torch.Tensor) -> torch.Tensor:
    """Round a float64 result once to float32 (emulates a fused op:
    the products of float32 values are exact in float64)."""
    return x.to(torch.float32)


def mandelbrot_variant(cr: torch.Tensor, ci: torch.Tensor, max_iters: int,
                       variant: str) -> torch.Tensor:
    """Escape counts with the chosen updates fused into one FMA."""
    zr, zi = torch.zeros_like(cr), torch.zeros_like(ci)
    cnt = torch.zeros(cr.shape, dtype=torch.int32)
    for _ in range(max_iters):
        zr2, zi2 = zr * zr, zi * zi
        escaped = zr2 + zi2 > 4.0
        if variant in ("fma_real", "fma_both"):     # fma(zr, zr, -zi2) + cr
            nzr = _fl(zr.double() * zr.double() - zi2.double()) + cr
        else:
            nzr = zr2 - zi2 + cr
        if variant in ("fma_imag", "fma_both"):     # fma(2zr, zi, ci)
            nzi = _fl((2.0 * zr).double() * zi.double() + ci.double())
        else:
            nzi = 2.0 * zr * zi + ci
        zr = torch.where(escaped, zr, nzr)
        zi = torch.where(escaped, zi, nzi)
        cnt += (~escaped).to(torch.int32)
    return cnt


def fma_variant_diffs(side: int, max_iters: int,
                      variants=VARIANTS) -> dict:
    """Pixels in which each variant differs from the JAX Pallas kernel,
    on the JAX grid."""
    cr, ci = jm.grid(side)
    want = np.asarray(jops.mandelbrot(cr, ci, max_iters=max_iters,
                                      bm=min(128, side), bn=min(128, side)))
    tcr = torch.from_numpy(np.array(cr))
    tci = torch.from_numpy(np.array(ci))
    return {v: int((mandelbrot_variant(tcr, tci, max_iters, v).numpy()
                    != want).sum()) for v in variants}


def test_only_the_imaginary_fma_reproduces_jax():
    d = fma_variant_diffs(512, 256, ("no_fma", "fma_imag"))
    assert d["fma_imag"] == 0
    assert d["no_fma"] > 0          # turning contraction off is wrong


# ----------------------------------------------------------- finding 2
def _eager_jax_linspace(a: float, b: float, n: int) -> np.ndarray:
    """JAX's own linspace formula, evaluated op by op in float32."""
    f = np.float32
    step = (np.arange(n - 1, dtype=f) / f(n - 1)).astype(f)
    out = f(a) * (f(1) - step) + f(b) * step
    return np.concatenate([out, [f(b)]]).astype(f)


def linspace_diffs(side: int) -> dict:
    """Per axis, values of each method that differ from the JAX grid's."""
    x0, x1, y0, y1 = jm.REGION
    jcr, jci = (np.asarray(a) for a in jm.grid(side))
    want = (jcr[0], jci[:, 0])
    methods = {
        "torch.linspace_f32": lambda a, b: torch.linspace(
            a, b, side, dtype=torch.float32).numpy(),
        "numpy_f32": lambda a, b: np.linspace(a, b, side, dtype=np.float32),
        "numpy_f64_rounded": lambda a, b: np.linspace(
            a, b, side).astype(np.float32),
        "jax_formula_eager": lambda a, b: _eager_jax_linspace(a, b, side),
    }
    return {name: tuple(int((fn(a, b) != w).sum())
                        for (a, b), w in zip(((x0, x1), (y0, y1)), want))
            for name, fn in methods.items()}


def own_grid_gap(side: int, max_iters: int) -> dict:
    """The port's grid and image against the JAX package's."""
    jcr, jci = (np.asarray(a) for a in jm.grid(side))
    cr, ci = (a.numpy() for a in tm.grid(side, device="cpu"))
    got = tm.escape_counts(side, max_iters, device="cpu")
    want = jm.escape_counts(side, max_iters)
    return {"max_abs_grid_gap": float(max(np.abs(cr - jcr).max(),
                                          np.abs(ci - jci).max())),
            "differing_pixels": int((got != want).sum()),
            "pixels": got.size,
            "iterations_rel_gap": float(abs(int(got.sum()) - int(want.sum()))
                                        / int(want.sum()))}


def test_no_eager_linspace_reproduces_xla():
    for name, (dx, dy) in linspace_diffs(512).items():
        assert dx + dy > 0, name


# ----------------------------------------------------------- finding 3
def spin_image_gaps(bo: int, cloud_n: int) -> dict:
    """Bins differing (and points moved) between the JAX Pallas kernel,
    its jnp oracle, and the port's plain version, on JAX's data."""
    pts = jp.cloud(cloud_n)
    ctr, nrm = jp.oriented_points(bo)
    kw = dict(n_alpha=jp.N_ALPHA, n_beta=jp.N_BETA, alpha_max=3.0,
              beta_max=3.0)
    kernel = np.asarray(jops.spin_image(pts, ctr, nrm, block_p=1024, **kw))
    oracle = np.asarray(jref.spin_image(pts, ctr, nrm, **kw))
    data = tp.from_reference(np.asarray(pts), np.asarray(ctr),
                             np.asarray(nrm), device="cpu")
    port = tp.compute_tasks(np.arange(bo), data=data)

    def gap(a, b):
        return {"bins": int((a != b).sum()),
                "moved": float(np.abs(a - b).sum() / 2)}
    return {"binned": float(kernel.sum()),
            "kernel_vs_oracle": gap(kernel, oracle),
            "port_vs_kernel": gap(port, kernel),
            "port_vs_oracle": gap(port, oracle),
            "totals_equal": bool(kernel.sum() == oracle.sum() == port.sum())}


def test_spin_image_bound_at_paper_cloud():
    g = spin_image_gaps(16, jp.CLOUD)
    assert g["totals_equal"]
    for pair in ("port_vs_kernel", "port_vs_oracle"):
        assert g[pair]["moved"] <= 1e-4 * g["binned"], (pair, g)


if __name__ == "__main__":
    print("finding 1, differing pixels vs the Pallas kernel (512/256):",
          fma_variant_diffs(512, 256))
    print("finding 2, differing linspace values (x, y) of 512:",
          linspace_diffs(512))
    print("finding 2, port grid vs JAX grid (128/64):", own_grid_gap(128, 64))
    print("finding 2, port grid vs JAX grid (512/256):",
          own_grid_gap(512, 256))
    print("finding 3, 64 centers x 16,384 points:",
          spin_image_gaps(64, jp.CLOUD))
