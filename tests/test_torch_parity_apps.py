"""The port's apps and kernels (repro_torch, on the CPU, through the
kernels' plain PyTorch versions) against the JAX package (repro, its
Pallas kernels in interpret mode and its jnp oracles).

Tolerances, each with its reason:
  * Mandelbrot on a shared grid: exact.  Both round every operation on
    its own except the imaginary update, one fused multiply-add.
  * The port's own grid: within 1e-6 absolute of JAX's (XLA's compiled
    linspace rounds differently; near zero a 1e-7 gap is hundreds of
    ulps), so at most 4 of 128 x 128 escape counts differ (1 measured)
    and task-time sums agree within 1e-4 relative.
  * Spin images: no point is lost, and at most 1 in 10^4 of the binned
    points changes bin.  beta and |x - c|^2 are sums whose order differs
    between the frameworks, so a point on a bin edge may move.
"""

import numpy as np
import pytest
import torch

from repro.apps import mandelbrot as jm
from repro.apps import psia as jp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import api as tapi
from repro_torch.apps import mandelbrot as tm
from repro_torch.apps import psia as tp
from repro_torch.kernels import dispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.runtime import FnBackend

CPU = "cpu"


def _jax_grid(side: int):
    cr, ci = jm.grid(side)
    return np.asarray(cr), np.asarray(ci)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


# ----------------------------------------------------------- (a) kernel
@pytest.mark.parametrize("rows,cols,max_iters", [
    (slice(None), slice(None), 64),          # 128 x 128
    (slice(0, 96), slice(16, 96), 64),       # ragged 96 x 80
], ids=["128x128", "ragged96x80"])
def test_mandelbrot_exact_on_shared_grid(rows, cols, max_iters):
    cr, ci = _jax_grid(128)
    cr, ci = cr[rows, cols], ci[rows, cols]
    want_kernel = np.asarray(jops.mandelbrot(cr, ci, max_iters=max_iters))
    want_ref = np.asarray(jref.mandelbrot(cr, ci, max_iters))
    got = tops.mandelbrot(_t(cr), _t(ci), max_iters=max_iters).numpy()
    got_plain = tref.mandelbrot(_t(cr), _t(ci), max_iters).numpy()
    assert got.dtype == np.int32 and got.shape == cr.shape
    np.testing.assert_array_equal(got, want_kernel)
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got_plain, got)
    assert dispatch.status("mandelbrot")["path"] == "torch"


# ------------------------------------------------------------- (b) grid
def test_grid_within_bound():
    jcr, jci = _jax_grid(128)
    cr, ci = tm.grid(128, device=CPU)
    assert cr.dtype == torch.float32 and cr.shape == (128, 128)
    assert np.abs(cr.numpy() - jcr).max() <= 1e-6
    assert np.abs(ci.numpy() - jci).max() <= 1e-6


def test_escape_counts_own_grid_bounded():
    got = tm.escape_counts(128, 64, device=CPU)
    want = jm.escape_counts(128, 64)
    assert (got != want).sum() <= 4
    tt = tm.task_times(1024, side=128, max_iters=64, device=CPU)
    jtt = jm.task_times(1024, side=128, max_iters=64)
    assert tt.shape == jtt.shape
    assert abs(tt.sum() - jtt.sum()) <= 1e-4 * jtt.sum()


def test_escape_counts_carried_grid_exact():
    c = _jax_grid(128)
    got = tm.escape_counts(128, 64, device=CPU, c=c)
    np.testing.assert_array_equal(got, jm.escape_counts(128, 64))
    np.testing.assert_array_equal(
        tm.task_times(1024, side=128, max_iters=64, device=CPU, c=c),
        jm.task_times(1024, side=128, max_iters=64))


# ------------------------------------------------------- (c) spin image
def _reference_data(bo: int = 64, cloud_n: int = 512):
    pts = np.asarray(jp.cloud(cloud_n))
    ctr, nrm = (np.asarray(a) for a in jp.oriented_points(bo))
    return pts, ctr, nrm


def _assert_bounded(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    assert got.sum() == want.sum()                        # nothing lost
    moved = np.abs(got - want).sum() / 2
    assert moved <= 1e-4 * want.sum(), (moved, want.sum())


def test_psia_compute_tasks_against_jax():
    pts, ctr, nrm = _reference_data()
    ids = np.arange(64)
    want = np.asarray(jp.compute_tasks(ids, n=64, cloud_n=512))
    data = tp.from_reference(pts, ctr, nrm, device=CPU)
    got = tp.compute_tasks(ids, data=data)
    assert got.dtype == np.float32
    _assert_bounded(got, want)


@pytest.mark.parametrize("n_alpha,n_beta,alpha_max,beta_max", [
    (64, 64, 3.0, 3.0), (32, 16, 2.0, 1.5)])
def test_spin_image_against_jax_kernel_and_ref(n_alpha, n_beta, alpha_max,
                                               beta_max):
    pts, ctr, nrm = _reference_data()
    kw = dict(n_alpha=n_alpha, n_beta=n_beta, alpha_max=alpha_max,
              beta_max=beta_max)
    want_kernel = np.asarray(jops.spin_image(pts, ctr, nrm, block_p=256,
                                             **kw))
    want_ref = np.asarray(jref.spin_image(pts, ctr, nrm, **kw))
    got = tops.spin_image(_t(pts), _t(ctr), _t(nrm), **kw).numpy()
    _assert_bounded(got, want_kernel)
    _assert_bounded(got, want_ref)
    np.testing.assert_array_equal(
        tref.spin_image(_t(pts), _t(ctr), _t(nrm), **kw).numpy(), got)
    assert dispatch.status("spin_image")["path"] == "torch"


def _spin_image_numpy(pts, ctr, nrm, n_alpha, n_beta, alpha_max, beta_max):
    """numpy float32, the kernel's operation order: every ufunc (sqrt
    included) is one correctly rounded IEEE operation."""
    f = np.float32
    d = pts[None, :, :] - ctr[:, None, :]
    n = nrm[:, None, :]
    beta = (d[..., 0] * n[..., 0] + d[..., 1] * n[..., 1]) + d[..., 2] * n[..., 2]
    r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    alpha = np.sqrt(np.maximum(r2 - beta * beta, f(0)))
    af = np.floor(alpha / f(alpha_max) * f(n_alpha))
    bf = np.floor((beta + f(beta_max)) / f(2 * beta_max) * f(n_beta))
    out = np.zeros((ctr.shape[0], n_beta * n_alpha), np.float32)
    for b in range(ctr.shape[0]):
        ok = (af[b] >= 0) & (af[b] < n_alpha) & (bf[b] >= 0) & (bf[b] < n_beta)
        idx = (bf[b][ok] * n_alpha + af[b][ok]).astype(np.int64)
        out[b] = np.bincount(idx, minlength=n_beta * n_alpha)
    return out.reshape(-1, n_beta, n_alpha)


def test_spin_image_plain_equals_numpy_ieee():
    """The plain version rounds every operation correctly, as the kernel
    does: exactly equal to a numpy float32 implementation at the paper's
    cloud size (PyTorch's own CPU float32 sqrt is not correctly rounded)."""
    pts, ctr, nrm = _reference_data(bo=32, cloud_n=jp.CLOUD)
    kw = dict(n_alpha=64, n_beta=64, alpha_max=3.0, beta_max=3.0)
    want = _spin_image_numpy(pts, ctr, nrm, **kw)
    got = tref.spin_image(_t(pts), _t(ctr), _t(nrm), **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_sqrt_rn_is_correctly_rounded():
    """numpy's float32 sqrt is the IEEE operation; PyTorch's CPU one is
    not, which would move points on bin edges between CPU and card."""
    from repro_torch.kernels.spin_image import sqrt_rn
    x = np.random.default_rng(3).uniform(0, 20, 1 << 20).astype(np.float32)
    np.testing.assert_array_equal(sqrt_rn(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))


def test_psia_own_data_shapes_and_task_times():
    pts = tp.cloud(512, device=CPU)
    ctr, nrm = tp.oriented_points(64, device=CPU)
    assert pts.shape == (512, 3) and ctr.shape == nrm.shape == (64, 3)
    np.testing.assert_allclose(torch.linalg.norm(nrm, dim=-1).numpy(), 1.0,
                               atol=1e-6)
    np.testing.assert_array_equal(tp.task_times(100), jp.task_times(100))
    a = tp.compute_tasks([3, 5, 7], n=64, cloud_n=512, device=CPU)
    b = tp.compute_tasks([3, 5, 7], n=64, cloud_n=512, device=CPU)
    np.testing.assert_array_equal(a, b)                  # idempotent
    assert a.shape == (3, tp.N_BETA, tp.N_ALPHA)


# --------------------------------------------------- (e) the slice whole
@pytest.mark.parametrize("shared_grid", [True, False],
                         ids=["jax_grid", "own_grid"])
def test_mandelbrot_tiles_survive_failures_threaded(shared_grid):
    """Twin of tests/test_apps.py::test_mandelbrot_tiles_survive_failures
    through the port's threaded engine: P=3, worker 1 fail-stops holding
    a chunk, rDLB re-issues it, the image is loss-less."""
    side, tile, max_iters = 128, 32, 64
    n = tm.n_tiles(side, tile)
    if shared_grid:
        cr, ci = (_t(a) for a in _jax_grid(side))
        per_row = side // tile

        def task_fn(t):
            ty, tx = divmod(t, per_row)
            sl = (slice(ty * tile, (ty + 1) * tile),
                  slice(tx * tile, (tx + 1) * tile))
            return tops.mandelbrot(cr[sl].contiguous(), ci[sl].contiguous(),
                                   max_iters=max_iters).numpy()
        want = jm.escape_counts(side, max_iters)
    else:
        def task_fn(t):
            return tm.compute_tile(t, side=side, tile=tile,
                                   max_iters=max_iters, device=CPU)
        want = tm.escape_counts(side, max_iters, device=CPU)
    spec = tapi.RunSpec(
        scheduling=tapi.SchedulingSpec(technique="SS"),
        cluster=tapi.ClusterSpec(n_workers=3, workers=(
            tapi.WorkerSpec(), tapi.WorkerSpec(fail_after_tasks=2),
            tapi.WorkerSpec())),
        execution=tapi.ExecutionSpec(mode="threaded"), n_tasks=n)
    backend = FnBackend(task_fn=task_fn)
    st = tapi.execute(spec, backend)
    assert not st.hung and st.n_finished == n
    assert st.n_duplicates > 0
    img = tm.assemble(backend.results, side=side, tile=tile)
    np.testing.assert_array_equal(img, want)


# ----------------------------------------------------------- (f) the CLI
@pytest.mark.parametrize("workload", [
    {"kind": "uniform", "n": 256, "t": 0.01},
    {"kind": "normal", "n": 300, "mean": 0.01, "sd": 0.004, "seed": 2},
    {"kind": "psia", "n": 400},
], ids=["uniform", "normal", "psia"])
def test_cli_run_matches_reference(workload, tmp_path, capsys):
    import json

    from repro.api import cli as jcli
    from repro_torch.api import cli as tcli
    doc = {"workload": workload,
           "spec": {"scheduling": {"technique": "FAC"},
                    "cluster": {"n_workers": 4}},
           "sweep": [{"name": "gss", "overrides":
                      {"scheduling.technique": "GSS"}},
                     {"name": "off", "overrides":
                      {"robustness.rdlb_enabled": False}}]}
    path = tmp_path / "run.json"
    path.write_text(json.dumps(doc))
    assert jcli.main(["run", "--spec", str(path)]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["run", "--spec", str(path), "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.count("run,") == 2


def test_cli_trace_calibrate_raises(tmp_path):
    from repro_torch.api import cli as tcli
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tcli.main(["trace", "calibrate", str(tmp_path / "t.json"),
                   "--spec", str(tmp_path / "s.json")])


# ------------------------------------------------- wrapper input checks
@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "mismatch"])
def test_mandelbrot_wrapper_rejects(bad):
    a = torch.zeros(8, 8)
    b = torch.zeros(8, 8)
    if bad == "dtype":
        a = a.double()
    elif bad == "shape":
        a, b = a.reshape(64), b.reshape(64)
    elif bad == "contiguous":
        a = a.t()[:, :4]
        b = b[:, :4]
    else:
        b = torch.zeros(8, 4)
    with pytest.raises((TypeError, ValueError)):
        tops.mandelbrot(a, b, max_iters=4)


@pytest.mark.parametrize("bad", ["dtype", "shape", "mismatch", "bins"])
def test_spin_image_wrapper_rejects(bad):
    p, c, n = torch.zeros(16, 3), torch.zeros(4, 3), torch.ones(4, 3)
    kw = dict(n_alpha=8, n_beta=8)
    if bad == "dtype":
        p = p.double()
    elif bad == "shape":
        p = torch.zeros(16, 2)
    elif bad == "mismatch":
        n = torch.ones(5, 3)
    else:
        kw = dict(n_alpha=256, n_beta=256)       # 256 KB of int32 bins
    with pytest.raises((TypeError, ValueError)):
        tops.spin_image(p, c, n, **kw)
