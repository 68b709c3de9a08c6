"""The CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with ``nvcc`` (sm_90a): they are marked
``cuda`` and skip elsewhere.  On the card, run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: none for mandelbrot and spin_image, whose kernels round
every operation as their plain versions do.  The decode kernels sum in
another order than the plain versions' library reductions: float32
attention within 1e-5, bfloat16 attention within one rounding of the
output (1e-4 + 2**-7 of its size), wkv6 within 1e-5 (one step) and 1e-4
(chunked) of the output's scale.  Full-sequence attention likewise, its
log-sum-exp within 1e-5 + 1e-6 of its size, and its gradients (the
backward in PyTorch ops from the kernel's output and log-sum-exp, against
autograd through the plain version) within 1e-5 (float32) and 2**-6
(bfloat16) of their largest magnitude.  Its bfloat16 output adds
``kf.bf16_p_bound``: the wgmma variant rounds P to bfloat16 before P V
(as the TPU's matrix unit did), the plain version keeps it float32.
The batched simulator (``core/devicesim``, batched PyTorch ops) on the
card against the same call on the CPU: t_par within 1e-9, every flag and
integer field identical.  ``WKV6BatchedFn``'s gradients (the backward in
PyTorch ops) against autograd through the plain version within 1e-4
(float32) and 2**-6 (bfloat16) of their largest magnitude; rwkv6 training
on the card against the CPU as olmo's; checkpoints of CUDA tensors bit
for bit; process mode on the card (spawned children): tiles and tokens
equal the in-process results exactly, every child on the kernels.
rwkv6's prefill in segments replayed from CUDA graphs against its
one-shot prefill, bfloat16 at full width: the last logits within
``SEGMENT_LOGITS_TOL`` (2**-5) of the largest, the same greedy token.
"""

import importlib.util
from pathlib import Path

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
                                           (17, 300, 256), (64, 40, 13),
                                           (64, 40, 1), (8, 8, 0)])
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


@pytest.mark.parametrize("tile_id", [0, 5, 29, 63])
def test_mandelbrot_kernel_on_strided_tiles(cuda, tile_id):
    """The rDLB task's shape: a 64 x 64 view of the 512 x 512 grid (29 is
    the deepest tile), launched in place, once per call, the same bits on
    a second launch."""
    cr, ci = mandelbrot.grid(512, device=cuda)
    ty, tx = divmod(tile_id, 8)
    sl = (slice(ty * 64, (ty + 1) * 64), slice(tx * 64, (tx + 1) * 64))
    a, b = cr[sl], ci[sl]
    assert not a.is_contiguous()
    before = dispatch.launches("mandelbrot")
    got = km.mandelbrot(a, b, max_iters=256)
    torch.cuda.synchronize()
    assert dispatch.launches("mandelbrot") == before + 1
    assert got.is_contiguous() and got.shape == (64, 64)
    assert torch.equal(got, km.mandelbrot_plain(a, b, 256))
    assert torch.equal(km.mandelbrot(a, b, max_iters=256), got)


@pytest.mark.parametrize("cloud", ["paper", "one short", "unaligned"])
@pytest.mark.parametrize("bo", [1, 2, 39, 313, 2500])
def test_spin_image_kernel_at_the_runs_chunks(cuda, bo, cloud):
    """FAC chunk sizes of the PSIA run (8, 8, 8, 1 and 1 CTAs a center)
    over the paper's cloud, one a point short, which no split divides,
    and the same cloud one point into a buffer, 12 bytes off 16-byte
    alignment (the kernel's element loads instead of float4 ones): bin for
    bin, once counted per call, the same bits twice."""
    data = psia.dataset(n=psia.PAPER_N, cloud_n=psia.CLOUD, device=cuda)
    pts = data.points[:-1] if cloud == "one short" else data.points
    if cloud == "unaligned":
        buf = torch.empty((psia.CLOUD + 1, 3), device=cuda)
        buf[1:] = data.points
        pts = buf[1:]
        assert pts.is_contiguous() and pts.data_ptr() % 16 != 0
    ctr, nrm = data.centers[:bo].contiguous(), data.normals[:bo].contiguous()
    kw = dict(n_alpha=psia.N_ALPHA, n_beta=psia.N_BETA,
              alpha_max=psia.ALPHA_MAX, beta_max=psia.BETA_MAX)
    before = dispatch.launches("spin_image")
    got = ks.spin_image(pts, ctr, nrm, **kw)
    torch.cuda.synchronize()
    assert dispatch.launches("spin_image") == before + 1
    assert dispatch.status("spin_image")["path"] == "cuda"
    assert torch.equal(got, ks.spin_image_plain(pts, ctr, nrm, **kw))
    assert torch.equal(ks.spin_image(pts, ctr, nrm, **kw), got)


@pytest.mark.parametrize("bo", [1, 300])
def test_spin_image_kernel_on_bin_edges(cuda, bo):
    """Points exactly on bin edges and range ends, and one ulp to either
    side: the fast binning's guard sends them to the exact chain."""
    kw = dict(n_alpha=psia.N_ALPHA, n_beta=psia.N_BETA,
              alpha_max=psia.ALPHA_MAX, beta_max=psia.BETA_MAX)
    pts, c, n = (x.to(cuda) for x in ks.bin_edge_cloud(**kw))
    c, n = c.expand(bo, 3).contiguous(), n.expand(bo, 3).contiguous()
    got = ks.spin_image(pts, c, n, **kw)
    assert torch.equal(got, ks.spin_image_plain(pts, c, n, **kw))
    assert got.sum() > 0


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


@pytest.mark.parametrize("L,D", [(128, 128), (129, 128), (777, 64),
                                 (1016, 128), (4000, 256), (300, 40)])
def test_flash_decode_splits_equal_plain(cuda, L, D):
    """One split (L = 128) and many, ragged ranges, a fully masked split,
    element loads (D = 40), and the split mirror on the same inputs."""
    gen = torch.Generator().manual_seed(L + D)
    B = 4
    q, k, v = (torch.randn(s, generator=gen).to(cuda)
               for s in ((B, D), (B, L, D), (B, L, D)))
    valid = _mask(L, 4, gen)
    n = kf.decode_splits(L)
    j0, j1 = kf.split_ranges(L, n)[n // 2]
    valid[j0:j1] = False                     # one split sees no valid slot
    valid = valid.to(cuda)
    got = kf.flash_decode(q, k, v, valid)
    torch.testing.assert_close(got, kf.flash_decode_plain(q, k, v, valid),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(
        got, kf.flash_decode_split_plain(q, k, v, valid), atol=1e-5, rtol=0)
    assert torch.equal(got, kf.flash_decode(q, k, v, valid))


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


def _wkv(cuda, BH, T, dk, dtype, gen, w=None):
    """Inputs on the card; w uniform in [0.05, 0.95], or the constant
    ``w``."""
    lead = (BH, T) if T else (BH,)
    r, k, v = (torch.randn(lead + (dk,), generator=gen) for _ in range(3))
    ww = torch.rand(lead + (dk,), generator=gen) * 0.9 + 0.05
    if w is not None:
        ww = torch.full_like(ww, w)
    u = torch.randn((BH, dk), generator=gen)
    s = torch.randn((BH, dk, dk), generator=gen)
    return ([t.to(cuda, dtype) for t in (r, k, v, ww, u)]
            + [s.to(cuda)])


def _close_scaled(got, want, rel):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=rel * float(want.abs().max()))


def _repeats_in_place(fn, ins, y, s):
    """A second launch gives the first one's bits, and so does the launch
    that writes the new state over the old one."""
    y2, s2 = fn(*ins)
    assert torch.equal(y2, y) and torch.equal(s2, s)
    state = ins[5].clone()
    y3, out = fn(*ins[:5], state, out_state=state)
    assert out is state
    assert torch.equal(y3, y) and torch.equal(state, s)


# (BH, w): rwkv6-1.6b's heads at B = 8 and B = 1 (the serving path's
# shape, 8 CTAs a head), and strong decay
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,w", [(256, None), (32, None), (32, 0.01)])
def test_wkv6_decode_kernel_equals_plain(cuda, BH, w, dtype):
    ins = _wkv(cuda, BH, 0, 64, dtype, torch.Generator().manual_seed(BH),
               w=w)
    y, s = kw.wkv6_decode(*ins)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    want_y, want_s = kw.wkv6_decode_plain(*ins)
    _close_scaled(y, want_y, 1e-5)
    _close_scaled(s, want_s, 1e-5)
    _repeats_in_place(kw.wkv6_decode, ins, y, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,T,w", [
    (64, 64, None), (64, 37, None), (64, 1, None), (32, 1000, None),
    (32, 37, None), (32, 64, 0.01)])
def test_wkv6_batched_kernel_equals_plain(cuda, BH, T, w, dtype):
    ins = _wkv(cuda, BH, T, 64, dtype, torch.Generator().manual_seed(T),
               w=w)
    y, s = kw.wkv6_batched(*ins)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    want_y, want_s = kw.wkv6_batched_plain(*ins)
    _close_scaled(y, want_y, 1e-4)
    _close_scaled(s, want_s, 1e-4)
    _repeats_in_place(kw.wkv6_batched, ins, y, s)


def _misaligned(t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# dk = 16 (rwkv6-smoke's head dim: 2 CTAs a head, and the prefill body for
# any dk) and inputs one element off 16 bytes (the element-wise loads), at
# the serving path's BH = 32; the batched T = 100 is four chunks, the last
# ragged, so both parities of A are reused
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dk,offset", [(16, False), (16, True), (64, True)])
@pytest.mark.parametrize("kernel", ["wkv6_decode", "wkv6_batched"])
def test_wkv6_kernels_at_other_head_dims_and_alignments(cuda, kernel, dk,
                                                         offset, dtype):
    T, tol = (0, 1e-5) if kernel == "wkv6_decode" else (100, 1e-4)
    fn, plain = getattr(kw, kernel), getattr(kw, kernel + "_plain")
    ins = _wkv(cuda, 32, T, dk, dtype, torch.Generator().manual_seed(dk))
    if offset:
        ins = [_misaligned(t) for t in ins]
        assert all(t.data_ptr() % 16 for t in ins)
    before = dispatch.launches(kernel)
    y, s = fn(*ins)
    torch.cuda.synchronize()
    assert dispatch.launches(kernel) == before + 1
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    want_y, want_s = plain(*ins)
    _close_scaled(y, want_y, tol)
    _close_scaled(s, want_s, tol)
    y2, s2 = fn(*ins)
    assert torch.equal(y2, y) and torch.equal(s2, s)
    state = _misaligned(ins[5]) if offset else ins[5].clone()
    y3, out = fn(*ins[:5], state, out_state=state)
    assert out is state
    assert torch.equal(y3, y) and torch.equal(state, s)


def _wkv_grads(fn, ins, dy, ds):
    leaves = [t.detach().clone().requires_grad_() for t in ins]
    y, s = fn(*leaves)
    return torch.autograd.grad((y.float() * dy).sum() + (s * ds).sum(),
                               leaves)


# WKV6BatchedFn on the card: the training shape (BH = 32) at a shorter T,
# a ragged T in both dtypes, and strong decay; the kernel's forward and
# the backward's ops against autograd through the plain version (1e-4 of
# each gradient's largest magnitude in float32, 2**-6 in bfloat16)
@pytest.mark.parametrize("BH,T,dtype,w", [
    (32, 512, torch.bfloat16, None), (32, 200, torch.float32, None),
    (32, 200, torch.bfloat16, None), (32, 100, torch.float32, 0.01),
    (32, 100, torch.bfloat16, 0.01)])
def test_wkv6_batched_grads_equal_plain_autograd(cuda, BH, T, dtype, w):
    gen = torch.Generator().manual_seed(T)
    ins = _wkv(cuda, BH, T, 64, dtype, gen, w=w)
    dy = torch.randn((BH, T, 64), generator=gen).to(cuda)
    ds = torch.randn((BH, 64, 64), generator=gen).to(cuda)
    before = dispatch.launches("wkv6_batched")
    y, s = kw.wkv6_batched_train(*ins)
    torch.cuda.synchronize()
    assert dispatch.launches("wkv6_batched") == before + 1
    _close_scaled(y, kw.wkv6_batched_plain(*ins)[0], 1e-4)
    got = _wkv_grads(kw.wkv6_batched_train, ins, dy, ds)
    want = _wkv_grads(kw.wkv6_batched_plain, ins, dy, ds)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    for g, x, ref in zip(got, ins, want):
        assert g.dtype == x.dtype and torch.isfinite(g).all()
        _close_scaled(g.float(), ref.float(), tol)


def test_rwkv6_training_step_on_the_card_equals_cpu(cuda):
    """rwkv6-smoke (float32): a loss and its gradients on the card run
    wkv6_batched twice a layer (the forward and its recomputation) and
    match the same step on the CPU."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import as_tensors, batch_for_step
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.runtime.executor import value_and_grad
    cfg = get_smoke("rwkv6-1.6b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    batch = batch_for_step(cfg, 0, 2, 70)
    fn = lambda p, b: model.loss(p, b)[0]  # noqa: E731
    before = dispatch.launches("wkv6_batched")
    loss, grads = value_and_grad(fn, params, as_tensors(batch, cuda))
    torch.cuda.synchronize()
    assert dispatch.launches("wkv6_batched") == before + 2 * cfg.n_layers
    assert dispatch.status("wkv6_batched")["path"] == "cuda"
    closs, cgrads = value_and_grad(fn, tree_map(torch.Tensor.cpu, params),
                                   as_tensors(batch, "cpu"))
    assert abs(float(loss) - float(closs)) <= 1e-5 * abs(float(closs))
    for g, w in zip(tree_leaves(grads), tree_leaves(cgrads)):
        _close_scaled(g.cpu(), w, 1e-4)


def test_checkpoint_round_trip_of_cuda_tensors(cuda, tmp_path):
    """Leaves on the card are saved from host copies and restored onto
    the card or the CPU, bit for bit."""
    from repro_torch.checkpoint import (CheckpointManager,
                                        load_checkpoint)
    tree = {"w": torch.randn(3, 5, device=cuda).to(torch.bfloat16),
            "m": [torch.randn(7, device=cuda),
                  torch.tensor(3, dtype=torch.int32, device=cuda)]}
    mgr = CheckpointManager(tmp_path, interval=1)
    mgr.maybe_save(1, tree)
    tree["m"][0].zero_()                     # a later step, in place
    got, step = mgr.restore_latest(tree)
    assert step == 1 and got["w"].device.type == "cuda"
    assert torch.equal(got["w"], tree["w"])
    assert not torch.equal(got["m"][0], tree["m"][0])
    on_cpu, _ = load_checkpoint(mgr.latest(), tree, device="cpu")
    assert on_cpu["w"].device.type == "cpu"
    assert torch.equal(on_cpu["w"], tree["w"].cpu())
    assert torch.equal(on_cpu["m"][1], tree["m"][1].cpu())


ATTN_CASES = [  # (B, S, H, KV, D, Dv, causal)
    (1, 300, 16, 16, 128, 128, True), (2, 100, 8, 2, 64, 64, True),
    (2, 129, 4, 4, 64, 64, False), (1, 77, 4, 1, 192, 128, True),
    (1, 70, 2, 2, 256, 256, False), (3, 1, 2, 1, 16, 8, True),
    (2, 1, 4, 2, 128, 128, True), (1, 65, 2, 2, 64, 64, True)]


def _attn_inputs(cuda, case, dtype, gen):
    B, S, H, KV, D, Dv, _ = case
    return [torch.randn(s, generator=gen).to(cuda, dtype)
            for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, Dv))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_kernel_equals_plain(cuda, case, dtype):
    causal = case[-1]
    gen = torch.Generator().manual_seed(sum(case[:6]))
    q, k, v = _attn_inputs(cuda, case, dtype, gen)
    before = dispatch.launches("flash_attention")
    out, lse = kf.flash_attention_forward(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert dispatch.launches("flash_attention") == before + 1
    assert dispatch.status("flash_attention")["path"] == "cuda"
    tensor_cores = (dtype == torch.bfloat16
                    and (case[4], case[5]) in kf.WGMMA_DIMS)
    assert dispatch.status("flash_attention")["variant"] == (
        "wgmma" if tensor_cores else "fp32")
    want, want_lse = kf.flash_attention_forward_plain(q, k, v,
                                                      causal=causal)
    assert out.dtype == dtype and lse.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
    else:
        bound = kf.bf16_p_bound(q, k, v, causal=causal)
        diff = (out.float() - want.float()).abs()
        assert bool((diff <= 1e-4 + 2.0 ** -7 * want.float().abs()
                     + bound).all()), float(diff.max())
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES[:4])
def test_flash_attention_grads_equal_plain_autograd(cuda, case, dtype):
    causal = case[-1]
    gen = torch.Generator().manual_seed(7 + sum(case[:6]))
    ins = _attn_inputs(cuda, case, dtype, gen)
    dout = torch.randn(case[:3] + case[5:6], generator=gen).to(cuda, dtype)
    grads = []
    for fn in (kf.flash_attention_gqa, kf.flash_attention_gqa_plain):
        leaves = [t.clone().requires_grad_() for t in ins]
        grads.append(torch.autograd.grad(fn(*leaves, causal=causal),
                                         leaves, dout))
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    for g, w in zip(*grads):
        assert g.dtype == dtype
        _close_scaled(g.float(), w.float(), rel)


def test_flash_attention_misaligned_strides_take_fp32(cuda):
    """TMA needs 16-byte strides: a bf16 head dim of 128 read out of rows
    of 129 runs the fp32 variant, which reads through any strides, and
    matches the plain version within the float32 variant's tolerance."""
    q = torch.randn((1, 64, 2, 129), device=cuda,
                    dtype=torch.bfloat16)[..., :128]
    out, lse = kf.flash_attention_forward(q, q, q)
    torch.cuda.synchronize()
    assert dispatch.status("flash_attention")["variant"] == "fp32"
    want, want_lse = kf.flash_attention_forward_plain(q, q, q)
    diff = (out.float() - want.float()).abs()
    assert bool((diff <= 1e-4 + 2.0 ** -7 * want.float().abs()).all())
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)


def test_flash_attention_misaligned_strides_take_fp32_at_d256(cuda):
    """The same at paligemma's head dim: bf16 D = Dv = 256 read out of
    rows of 257 runs the fp32 variant, within its tolerance."""
    q = torch.randn((1, 70, 2, 257), device=cuda,
                    dtype=torch.bfloat16)[..., :256]
    out, lse = kf.flash_attention_forward(q, q, q)
    torch.cuda.synchronize()
    assert dispatch.status("flash_attention")["variant"] == "fp32"
    want, want_lse = kf.flash_attention_forward_plain(q, q, q)
    diff = (out.float() - want.float()).abs()
    assert bool((diff <= 1e-4 + 2.0 ** -7 * want.float().abs()).all())
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)


def test_flash_attention_duplicates_are_bit_identical(cuda):
    gen = torch.Generator().manual_seed(5)
    # wgmma at every head-dim pair: (64, 64), (128, 128), (192, 128) and
    # (256, 256)
    for case in (ATTN_CASES[1], ATTN_CASES[0], ATTN_CASES[3], ATTN_CASES[4]):
        q, k, v = _attn_inputs(cuda, case, torch.bfloat16, gen)
        a = kf.flash_attention_forward(q, k, v)
        b = kf.flash_attention_forward(q, k, v)
        assert dispatch.status("flash_attention")["variant"] == "wgmma"
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        dout = torch.randn_like(a[0])
        ga, gb = ([t.clone().requires_grad_() for t in (q, k, v)]
                  for _ in range(2))
        da = torch.autograd.grad(kf.flash_attention_gqa(*ga), ga, dout)
        db = torch.autograd.grad(kf.flash_attention_gqa(*gb), gb, dout)
        assert all(torch.equal(x, y) for x, y in zip(da, db))


def test_training_path_launches_flash_attention(cuda):
    """A loss and its gradients on the card go through the kernel, twice
    a layer (every layer is rematerialised: its forward runs again in the
    backward), and match the same step on the CPU (float32 smoke
    config)."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import as_tensors, batch_for_step
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.runtime.executor import value_and_grad
    cfg = get_smoke("olmo-1b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    batch = batch_for_step(cfg, 0, 2, 50)
    fn = lambda p, b: model.loss(p, b)[0]  # noqa: E731
    before = dispatch.launches("flash_attention")
    loss, grads = value_and_grad(fn, params, as_tensors(batch, cuda))
    torch.cuda.synchronize()
    assert dispatch.launches("flash_attention") == before + 2 * cfg.n_layers
    closs, cgrads = value_and_grad(fn, tree_map(torch.Tensor.cpu, params),
                                   as_tensors(batch, "cpu"))
    assert abs(float(loss) - float(closs)) <= 1e-5 * abs(float(closs))
    for g, w in zip(tree_leaves(grads), tree_leaves(cgrads)):
        _close_scaled(g.cpu(), w, 1e-4)


def test_bf16_training_path_launches_the_wgmma_variant(cuda):
    """In bfloat16 at head dim 64, every layer's attention of a loss and
    its gradients runs the wgmma variant (twice a layer: the forward and
    its recomputation)."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import as_tensors, batch_for_step
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.runtime.executor import value_and_grad
    cfg = get_smoke("olmo-1b").replace(d_model=128, n_heads=2, n_kv_heads=2)
    assert cfg.head_dim == 64 and cfg.dtype == "bfloat16"
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    fn = lambda p, b: model.loss(p, b)[0]  # noqa: E731
    before = dispatch.variant_launches("flash_attention").get("wgmma", 0)
    loss, grads = value_and_grad(fn, params, as_tensors(
        batch_for_step(cfg, 0, 2, 200), cuda))
    torch.cuda.synchronize()
    after = dispatch.variant_launches("flash_attention").get("wgmma", 0)
    assert after == before + 2 * cfg.n_layers
    assert torch.isfinite(torch.as_tensor(float(loss)))
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))


def test_bf16_paligemma_prefill_launches_the_wgmma_variant(cuda):
    """A bfloat16 paligemma-smoke-width prefill at head dim 256 (8 heads
    over one KV head, as paligemma-3b's) runs every layer's attention on
    the wgmma variant, once a layer."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    cfg = get_smoke("paligemma-3b").replace(n_heads=8, d_head=256)
    assert cfg.head_dim == 256 and cfg.dtype == "bfloat16"
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 37))).to(cuda)
    before = dispatch.variant_launches("flash_attention")
    with torch.inference_mode():
        logits, _ = model.prefill(params, model.init_cache(2, 40,
                                                           device=cuda),
                                  tokens)
    torch.cuda.synchronize()
    after = dispatch.variant_launches("flash_attention")
    assert after.get("wgmma", 0) == before.get("wgmma", 0) + cfg.n_layers
    assert after.get("fp32", 0) == before.get("fp32", 0)
    assert bool(torch.isfinite(logits.float()).all())


# ------------------------------------------- the batched simulator on the card
def _same_batch(got, want):
    """t_par (and the other float fields) within 1e-9 with infinities in
    the same places; flags and integer fields identical."""
    import dataclasses
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if a.dtype.kind == "f":
            assert np.array_equal(np.isinf(a), np.isinf(b)), f.name
            fin = np.isfinite(b)
            assert np.allclose(a[fin], b[fin], rtol=0, atol=1e-9), f.name
        else:
            assert np.array_equal(a, b), f.name


def _sim_spec(tech, P, rdlb=True):
    from repro_torch import api
    from repro_torch.core import faults
    return api.RunSpec(
        scheduling=api.SchedulingSpec(technique=tech),
        robustness=api.RobustnessSpec(rdlb_enabled=rdlb),
        cluster=api.ClusterSpec.from_scenario(faults.baseline(P)),
        execution=api.ExecutionSpec(h=1e-4))


@pytest.mark.parametrize("P", [4, 16, 64])
def test_devicesim_grid_on_card_equals_cpu(cuda, P):
    """The clean grid (SS / STATIC / mFSC / FSC, divisible, partial-chunk
    and tiny workloads, rdlb on and off) in one batch a workload: the
    card's batch equals the CPU's."""
    from repro_torch.core import devicesim
    for N in (4 * P, 4 * P + 3, 100):
        times = np.full(N, 0.01)
        lows = [devicesim.lower_run(_sim_spec(t, P, rd), times)[0]
                for t in ("SS", "STATIC", "mFSC", "FSC")
                for rd in (True, False)]
        before = devicesim.batch_calls("cuda")
        got = devicesim.simulate_many(lows, device=cuda)
        assert devicesim.batch_calls("cuda") > before
        assert got.valid.all()
        _same_batch(got, devicesim.simulate_many(lows, device="cpu"))


@pytest.mark.parametrize("rdlb", [True, False], ids=["rdlb", "no_rdlb"])
def test_devicesim_monte_carlo_on_card_equals_cpu(cuda, rdlb):
    """An MC batch at P = 8: three techniques x 64 paired fail-stop draws
    of 1 to 7 victims (the transaction tail), on the card and the CPU."""
    from repro_torch.core import devicesim
    P, N, D = 8, 200, 64
    times = np.full(N, 0.01)
    lows = [devicesim.lower_run(_sim_spec(t, P, rdlb), times)[0]
            for t in ("SS", "mFSC", "FSC")]
    rng = np.random.default_rng(11)
    fail = np.full((D, P), np.inf)
    for d in range(D):
        k = 1 + d % (P - 1)
        v = rng.choice(np.arange(1, P), size=k, replace=False)
        fail[d, v] = rng.uniform(0.02, 0.2, size=k)
    kw = dict(tech_of=np.repeat(np.arange(3, dtype=np.int32), D),
              fail_times=np.tile(fail, (3, 1)))
    got = devicesim.simulate_many(lows, device=cuda, **kw)
    _same_batch(got, devicesim.simulate_many(lows, device="cpu", **kw))
    assert got.valid.any() and got.hung.any() != rdlb


@pytest.mark.parametrize("arch", [
    "deepseek-v3-671b", "deepseek-v2-lite-16b", "deepseek-coder-33b",
    "qwen3-4b", "olmo-1b", "qwen2-72b", "paligemma-3b", "whisper-tiny",
    "rwkv6-1.6b", "hymba-1.5b"])
def test_smoke_config_on_the_card_equals_cpu(cuda, arch):
    """Each smoke config in float32: forward logits, three decode steps
    and one loss with its gradients (the routers' aux and deepseek-v3's
    MTP loss included) on the card, through the kernels its family
    launches, against the same calls on the CPU: logits within 1e-4 +
    1e-5 of their size, the loss within 1e-5 of it, gradients within 1e-4
    of each leaf's largest magnitude.  The check is ``chip_smoke.py``'s
    own (``smoke_gaps``), which runs it for all ten configs."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    gaps = chip_smoke.smoke_gaps(cuda, arch)
    assert chip_smoke.SMOKE_TOL == {"logits": (1e-4, 1e-5), "loss": 1e-5,
                                    "grads": 1e-4}
    assert gaps["ok"], gaps


# ------------------------------------------------------------ process mode
def _process_spec(n_tasks, workers):
    from repro_torch import api
    return api.RunSpec(
        scheduling=api.SchedulingSpec(technique="FAC"),
        cluster=api.ClusterSpec(n_workers=len(workers),
                                workers=tuple(workers)),
        execution=api.ExecutionSpec(mode="process", stall_timeout=60.0,
                                    wall_timeout=300.0),
        n_tasks=n_tasks)


def test_process_mode_tiles_on_the_card(cuda):
    """Mandelbrot tiles in spawned children on the card, one SIGKILLed
    after its first chunk: the image equals the card's own render, and
    every child that reported ran the kernel through ``cuda``."""
    import functools
    from repro_torch import api, cluster
    from repro_torch.runtime import FnBackend
    side, tile, iters = 256, 64, 64
    n = mandelbrot.n_tiles(side, tile)
    spec = _process_spec(n, [api.WorkerSpec(sleep_per_task=0.05),
                             api.WorkerSpec(sleep_per_task=0.05,
                                            fail_after_tasks=1)])
    backend = FnBackend(task_fn=functools.partial(
        mandelbrot.compute_tile, side=side, tile=tile, max_iters=iters,
        device="cuda"))
    cluster.reset_runs()
    st = api.execute(spec, backend)
    assert not st.hung and st.n_finished == n
    img = mandelbrot.assemble(backend.results, side=side, tile=tile)
    np.testing.assert_array_equal(
        img, mandelbrot.escape_counts(side, iters, device=cuda))
    (run,) = cluster.runs()
    reports = [c["kernels"] for c in run["children"].values()
               if c["kernels"] is not None]
    assert reports and all(r["status"]["mandelbrot"]["path"] == "cuda"
                           and r["launches"]["mandelbrot"] > 0
                           for r in reports)


def test_process_mode_serving_on_the_card(cuda):
    """A float32 smoke model served by spawned replicas on the card:
    tokens equal the threaded executor's, flash_decode launched in the
    children."""
    from repro_torch import api, cluster
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.runtime import RDLBServeExecutor, Request
    model = build_model(get_smoke("olmo-1b").replace(dtype="float32"))
    params = model.init(0, device=cuda)

    def reqs():
        r = np.random.default_rng(0)
        return [Request(i, r.integers(0, 512, size=5 + i % 3)
                        .astype(np.int32), max_new_tokens=4)
                for i in range(6)]

    spec = (api.serve_spec(n_workers=2).override("execution.mode", "process")
            .override("execution.stall_timeout", 60.0)
            .override("execution.wall_timeout", 300.0))
    cluster.reset_runs()
    got = reqs()
    assert not RDLBServeExecutor(model, params, spec=spec).serve(got).hung
    want = reqs()
    RDLBServeExecutor(model, params, spec=api.serve_spec(
        n_workers=2, threaded=True)).serve(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.output, w.output)
    (run,) = cluster.runs()
    reports = [c["kernels"] for c in run["children"].values()
               if c["kernels"] is not None]
    assert reports and all(r["launches"]["flash_decode"] > 0
                           for r in reports)


def test_process_mode_segments_rwkv6_prefills_on_the_card(cuda):
    """rwkv6-smoke (float32) served by spawned replicas on the card: the
    children prefill in segments replayed from CUDA graphs as threads
    do, so tokens equal the threaded executor's, and each child that
    prefilled reports at least one capture and wkv6_batched launched
    once a layer a segment."""
    from repro_torch import api, cluster
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.runtime import RDLBServeExecutor, Request
    from repro_torch.runtime import serve_executor as se
    cfg = get_smoke("rwkv6-1.6b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device=cuda)

    def reqs():
        r = np.random.default_rng(1)
        return [Request(i, r.integers(0, cfg.vocab_size, size=30 + 200 * i)
                        .astype(np.int32), max_new_tokens=3)
                for i in range(6)]

    spec = (api.serve_spec(n_workers=2).override("execution.mode", "process")
            .override("execution.stall_timeout", 60.0)
            .override("execution.wall_timeout", 300.0))
    cluster.reset_runs()
    got = reqs()
    assert not RDLBServeExecutor(model, params, spec=spec).serve(got).hung
    want = reqs()
    RDLBServeExecutor(model, params, spec=api.serve_spec(
        n_workers=2, threaded=True)).serve(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.output, w.output)
    (run,) = cluster.runs()
    reports = [c["kernels"] for c in run["children"].values()
               if c["kernels"] is not None
               and c["kernels"]["launches"].get("wkv6_batched")]
    assert reports
    for r in reports:
        captures = r["events"].get(se.PREFILL_CAPTURES, 0)
        segments = captures + r["events"].get(se.PREFILL_HITS, 0)
        assert captures >= 1
        assert r["launches"]["wkv6_batched"] == cfg.n_layers * segments
        assert r["status"]["wkv6_batched"]["path"] == "cuda"


@pytest.mark.parametrize("dtype,B,threads", [("float32", 1, 1),
                                             ("bfloat16", 3, 1),
                                             ("bfloat16", 1, 4)])
def test_fused_generator_graph_equals_eager(cuda, dtype, B, threads):
    """A dense model's groups replay one CUDA graph of the decode step
    each: the eager loop's tokens exactly, one flash_decode launch a
    layer a step counted (the captured launches once per replay), and,
    with several threads capturing and replaying at once, each thread's
    tokens its eager run's."""
    import threading

    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig
    from repro_torch.runtime.serve_executor import FusedGenerator
    cfg = ModelConfig(family="dense", n_layers=2, d_model=256, n_heads=4,
                      n_kv_heads=2, d_ff=512, vocab_size=512, dtype=dtype)
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    new = 9
    rng = np.random.default_rng(B)
    prompts = [rng.integers(0, cfg.vocab_size, size=(B, 37 + 8 * t))
               .astype(np.int32) for t in range(threads)]
    eager = FusedGenerator(model)
    eager.graphed = lambda device, steps: False
    want = [eager(params, p, new) for p in prompts]
    gen = FusedGenerator(model)
    assert gen.graphed(cuda, new - 1)
    got = [None] * threads
    dispatch.reset_launches()

    def run(t):
        got[t] = gen(params, prompts[t], new)
    pool = [threading.Thread(target=run, args=(t,)) for t in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert dispatch.launches("flash_decode") == (cfg.n_layers * (new - 1)
                                                 * threads)
    assert dispatch.status("flash_decode")["path"] == "cuda"


def _small_dense(cuda, dtype):
    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(family="dense", n_layers=2, d_model=256, n_heads=4,
                      n_kv_heads=2, d_ff=512, vocab_size=512, dtype=dtype)
    model = build_model(cfg)
    return cfg, model, model.init(0, device=cuda)


def _lanes(params) -> list:
    """The serving executor's free lanes of the device ``params`` lie on
    (its key: the device with its index)."""
    from repro_torch.models.common import first_tensor
    from repro_torch.runtime import serve_executor as se
    return se._free_lanes[first_tensor(params).device]


class _EagerGraph:
    """Stands in for a CUDA graph: a replay runs the step eagerly."""

    def __init__(self, step):
        self.replay = step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kept_graphs_capture_once_a_lane_and_capacity(cuda, dtype,
                                                      monkeypatch):
    """Groups of three (rows, capacity) keys served in turns, three
    rounds, on one thread: one lane, one capture a key in the first
    round and hits after it; every group's tokens those of the eager
    walk (each capacity read by one CTA a row, as the fresh cache is, so
    the bits agree); launches n_layers a step, replays included; reserved
    memory the same after every round."""
    from repro_torch.runtime import serve_executor as se
    monkeypatch.setattr(se, "_free_lanes", {})
    cfg, model, params = _small_dense(cuda, dtype)
    rng = np.random.default_rng(0)
    # (rows, S, new): capacities 64, 64, 64 at 2 rows, 128
    shapes = [(1, 37, 9), (1, 20, 12), (2, 50, 9), (1, 90, 30)]
    groups = [(rng.integers(0, cfg.vocab_size, size=(B, S))
               .astype(np.int32), n) for B, S, n in shapes]
    eager = se.FusedGenerator(model)
    eager.graphed = lambda device, steps: False
    want = [eager(params, p, n) for p, n in groups]
    gen = se.FusedGenerator(model)
    reserved = []
    for r in range(3):
        dispatch.reset_launches()
        for (p, n), w in zip(groups, want):
            np.testing.assert_array_equal(gen(params, p, n), w)
        steps = sum(n - 1 for _, n in groups)
        assert dispatch.launches("flash_decode") == cfg.n_layers * steps
        assert (dispatch.events(se.GRAPH_CAPTURES),
                dispatch.events(se.GRAPH_HITS)) == ((3, 1) if r == 0
                                                    else (0, 4))
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    (lane,) = _lanes(params)
    assert sorted(lane.kept) == [(1, 64), (1, 128), (2, 64)]
    assert reserved[0] == reserved[1] == reserved[2]


def test_kept_graphs_on_two_lanes_and_eager_agree(cuda, monkeypatch):
    """A bfloat16 request whose capacity (1,024 slots) takes eight CTAs a
    row: served on a lane, again while that lane is held (a duplicate on
    a second lane, which captures there), then twice more (hits), and
    on lanes whose captures replay eagerly (the eager walk of the same
    shapes): the same tokens bit for bit every time."""
    from repro_torch.runtime import serve_executor as se
    monkeypatch.setattr(se, "_free_lanes", {})
    cfg, model, params = _small_dense(cuda, "bfloat16")
    p = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(1, 700)).astype(np.int32)
    new = 20
    key = (1, se.cache_capacity(700 + new))
    assert key[1] == 1024
    gen = se.FusedGenerator(model)
    dispatch.reset_launches()
    first = gen(params, p, new)
    (lane,) = _lanes(params)
    with se._lane(lane.stream.device, model, params, key) as held:
        assert held is lane
        np.testing.assert_array_equal(gen(params, p, new), first)
    assert len(_lanes(params)) == 2
    for _ in range(2):
        np.testing.assert_array_equal(gen(params, p, new), first)
    assert dispatch.events(se.GRAPH_CAPTURES) == 2
    assert dispatch.events(se.GRAPH_HITS) == 2
    monkeypatch.setattr(se, "_free_lanes", {})
    monkeypatch.setattr(se, "_capture", lambda step, lane: (
        _EagerGraph(step), dispatch.Tally()))
    np.testing.assert_array_equal(gen(params, p, new), first)


def test_kept_graphs_under_threads(cuda, monkeypatch):
    """Four threads serving the same groups in other orders, three times
    over: each thread's tokens the single-thread walk's, and no lane
    captures a key twice (captures equal the kept graphs)."""
    import threading

    from repro_torch.runtime import serve_executor as se
    monkeypatch.setattr(se, "_free_lanes", {})
    cfg, model, params = _small_dense(cuda, "bfloat16")
    rng = np.random.default_rng(2)
    groups = [(rng.integers(0, cfg.vocab_size, size=(1, S))
               .astype(np.int32), n)
              for S, n in ((40, 8), (100, 20), (200, 30), (16, 10))]
    gen = se.FusedGenerator(model)
    want = [gen(params, p, n) for p, n in groups]
    dispatch.reset_launches()
    got: dict = {}

    def run(t):
        order = np.random.default_rng(10 + t).permutation(len(groups))
        for _ in range(3):
            for i in order:
                got[(t, int(i))] = gen(params, *groups[i])
    pool = [threading.Thread(target=run, args=(t,)) for t in range(4)]
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    for (t, i), toks in got.items():
        np.testing.assert_array_equal(toks, want[i])
    kept = sum(k.graph is not None for ln in _lanes(params)
               for k in ln.kept.values())
    assert dispatch.events(se.GRAPH_CAPTURES) + 3 == kept
    assert (dispatch.events(se.GRAPH_HITS)
            + dispatch.events(se.GRAPH_CAPTURES) == 4 * 3 * len(groups))


def test_kept_graphs_dropped_for_other_params(cuda, monkeypatch):
    """One lane serving a float32 model, a bfloat16 one, then the first
    again: each change of params drops the lane's graphs and its pool,
    and the next group captures anew into a fresh pool, to the eager
    walk's tokens."""
    from repro_torch.runtime import serve_executor as se
    monkeypatch.setattr(se, "_free_lanes", {})
    a, b = _small_dense(cuda, "float32"), _small_dense(cuda, "bfloat16")
    p = np.random.default_rng(3).integers(
        0, 512, size=(1, 40)).astype(np.int32)
    dispatch.reset_launches()
    pools = []
    for cfg, model, params in (a, b, a):
        eager = se.FusedGenerator(model)
        eager.graphed = lambda device, steps: False
        np.testing.assert_array_equal(se.FusedGenerator(model)(params, p, 9),
                                      eager(params, p, 9))
        (lane,) = _lanes(params)
        assert lane.owner[1] is params and len(lane.kept) == 1
        pools.append(lane.pool)
    assert dispatch.events(se.GRAPH_CAPTURES) == 3
    assert pools[0] != pools[1] != pools[2]


def _rwkv6_two_layers(cuda):
    """rwkv6-1.6b at its full width and 2 layers, in its bfloat16."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("rwkv6-1.6b").replace(n_layers=2)
    model = build_model(cfg)
    return cfg, model, model.init(0, device=cuda)


def _segment_prompts():
    """Prompt lengths at each segment length's boundaries, and a few
    that take several segments of both."""
    from repro_torch.runtime import serve_executor as se
    L, s = se.SEGMENT_LONG, se.SEGMENT_SHORT
    return (1, 33, s - 1, s, s + 1, L - 1, L, L + 1, L + s, L + s + 1,
            2 * L, 1100, 2040)


#: segmented prefill against the one-shot prefill, rwkv6 bf16 logits:
#: within this share of the largest logit's magnitude (a few bfloat16
#: roundings: the segments' products take other shapes)
SEGMENT_LOGITS_TOL = 2 ** -5


def test_segmented_prefill_graphs_equal_one_shot(cuda, monkeypatch):
    """Each prompt prefilled in segments on one lane, twice (the first
    pass captures each segment length once, after running it eagerly;
    the second replays every segment), against the eager one-shot
    prefill: the last logits within SEGMENT_LOGITS_TOL of the largest,
    the same greedy token (also through ``FusedGenerator``), and
    wkv6_batched launched once a layer a segment, replays included, on
    the card."""
    from repro_torch.runtime import serve_executor as se
    monkeypatch.setattr(se, "_free_lanes", {})
    cfg, model, params = _rwkv6_two_layers(cuda)
    gen = se.FusedGenerator(model)
    assert gen.segmented(cuda)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=(1, S)).astype(np.int32)
               for S in _segment_prompts()]
    want = []
    with torch.inference_mode():
        for p in prompts:
            state = model.init_cache(1, 0, device=cuda)
            logits, _ = model.prefill(params, state,
                                      torch.from_numpy(p).to(cuda))
            want.append(logits.float())
    key = (se._Segments, 1)
    for rnd in range(2):
        for p, w in zip(prompts, want):
            dispatch.reset_launches()
            with torch.inference_mode(), \
                    se._lane(cuda, model, params, key) as lane, \
                    se._on(lane):
                segs = lane.segments(model, params, 1, cuda)
                got, done = gen._prefill_segments(
                    params, lane, segs, torch.from_numpy(p).to(cuda))
                got = got.float().clone()
            n = len(se.prefill_segments(p.shape[1]))
            assert sum(done.values()) == n
            if rnd:
                assert done["prefill-capture"] == 0
            err = float((got - w).abs().max())
            assert err <= SEGMENT_LOGITS_TOL * float(w.abs().max()), (
                p.shape[1], err)
            assert torch.equal(got.argmax(-1), w.argmax(-1)), p.shape[1]
            assert dispatch.launches("wkv6_batched") == cfg.n_layers * n
            assert dispatch.status("wkv6_batched")["path"] == "cuda"
            toks = gen(params, p, 1)
            assert toks[0, 0] == int(w[0, -1].argmax())
    (lane,) = _lanes(params)
    (segs,) = lane.kept.values()
    assert set(segs.graphs) == {se.SEGMENT_LONG, se.SEGMENT_SHORT}


def test_segmented_prefill_under_threads(cuda, monkeypatch):
    """Four threads serving the same rwkv6 requests in other orders,
    twice over, capturing and replaying at once: each thread's tokens
    the single-thread walk's (a request's bits do not depend on its
    lane), no lane capturing a length twice, every segment a capture or
    a hit."""
    import threading

    from repro_torch.runtime import serve_executor as se
    monkeypatch.setattr(se, "_free_lanes", {})
    cfg, model, params = _rwkv6_two_layers(cuda)
    rng = np.random.default_rng(6)
    groups = [(rng.integers(0, cfg.vocab_size, size=(1, S))
               .astype(np.int32), n)
              for S, n in ((300, 1), (700, 3), (1030, 1), (130, 2))]
    gen = se.FusedGenerator(model)
    want = [gen(params, p, n) for p, n in groups]
    dispatch.reset_launches()
    got: dict = {}

    def run(t):
        order = np.random.default_rng(10 + t).permutation(len(groups))
        for _ in range(2):
            for i in order:
                got[(t, int(i))] = gen(params, *groups[i])
    pool = [threading.Thread(target=run, args=(t,)) for t in range(4)]
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    for (t, i), toks in got.items():
        np.testing.assert_array_equal(toks, want[i])
    kept = sum(len(k.graphs) for ln in _lanes(params)
               for k in ln.kept.values())
    assert dispatch.events(se.PREFILL_CAPTURES) + 2 == kept
    segments = sum(len(se.prefill_segments(p.shape[1])) for p, _ in groups)
    assert (dispatch.events(se.PREFILL_CAPTURES)
            + dispatch.events(se.PREFILL_HITS) == 4 * 2 * segments)
    assert dispatch.launches("wkv6_batched") == (cfg.n_layers * 4 * 2
                                                 * segments)
