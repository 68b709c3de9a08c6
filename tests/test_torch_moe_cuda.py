"""The dropless MoE kernels (``kernels/moe.py``, ``csrc/moe.cu``) and MLA's
decompressed prefill, on the card.

Marked ``cuda``, skipped elsewhere; on the card:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_moe_cuda.py

Tolerances: the routing (experts, ranks, the sorted order, the tile map)
equals the plain version exactly, the gates within 1e-6 (the kernel's
softmax sums in another order).  The grouped product's output within
2**-7 of its largest magnitude: both accumulate bf16 products in float32
but in other orders, and the hidden row is rounded to bf16 between the
two products, so one rounding step (2**-8 relative) of the hidden can
flip and is carried through W_down.
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import dispatch
from repro_torch.kernels import moe as km
from repro_torch.models import attention as attn
from repro_torch.models.registry import build_model

pytestmark = pytest.mark.cuda

YARN = {"type": "yarn", "factor": 40, "original_max_position_embeddings":
        4096, "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
        "mscale_all_dim": 0.707}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


def expert_inputs(dev, T, E, D, Fh, empty=(), seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(T, D, generator=g, device=dev).to(torch.bfloat16)
    logits = 2.0 * torch.randn(T, E, generator=g, device=dev)
    for e in empty:                     # no token routes here
        logits[:, e] = -1e4
    w = [(torch.randn(E, a, b, generator=g, device=dev) / a ** 0.5)
         .to(torch.bfloat16) for a, b in ((D, Fh), (D, Fh), (Fh, D))]
    return x, logits, w


@pytest.mark.parametrize("rows", [1, 6, 96, 300])
@pytest.mark.parametrize("norm", [False, True])
def test_grouped_kernel_equals_plain(cuda, rows, norm):
    """DeepSeek-V2-Lite's widths (E = 64, k = 6, d 2048, f 1408) at about
    ``rows`` routed rows an expert, experts 5 and 17 routed none; 1 and 6
    rows take the small_m variant (10 and 64 tokens), the rest the tile
    one."""
    E, K, D, Fh = 64, 6, 2048, 1408
    T = max(1, rows * E // K)
    x, logits, (wg, wu, wd) = expert_inputs(cuda, T, E, D, Fh, (5, 17),
                                            seed=rows)
    counter = torch.zeros(E, dtype=torch.int64, device=cuda)
    out, idx, gates = km.routed_experts(x, logits, wg, wu, wd, top_k=K,
                                        norm_topk=norm, scale=1.0,
                                        counter=counter)
    torch.cuda.synchronize()
    p_idx, p_gates = km.route_plain(logits, K, norm, 1.0)
    assert torch.equal(idx.long(), p_idx)
    torch.testing.assert_close(gates, p_gates, rtol=0, atol=1e-6)
    sch = km.schedule_plain(p_idx.cpu(), E, km.BM[km.variant(T)])
    assert torch.equal(counter.cpu(), sch["counts"])
    assert sch["counts"][5] == 0 and sch["counts"][17] == 0
    want = km.experts_plain(x, p_idx, p_gates, wg, wu, wd)
    scale = float(want.abs().max())
    torch.testing.assert_close(out, want, rtol=0, atol=2 ** -7 * scale)


def test_routing_bookkeeping_equals_plain(cuda):
    """The routing program's offsets, sorted order and tile map (read
    from its scratch through a probe of the launch) equal the plain
    schedule's; a tie between two experts keeps the lower first."""
    E, K, T = 64, 6, 700
    x, logits, (wg, wu, wd) = expert_inputs(cuda, T, E, 128, 64, (3,))
    logits[0, 10] = logits[0, 11] = 50.0          # a tie at the top
    seen = {}
    real = km._segments

    def probe(sizes, dtype, device):
        views = real(sizes, dtype, device)
        seen.setdefault(dtype, views)
        return views
    km._segments = probe
    try:
        counter = torch.zeros(E, dtype=torch.int64, device=cuda)
        _, idx, _ = km.routed_experts(x, logits, wg, wu, wd, top_k=K,
                                      norm_topk=False, scale=1.0,
                                      counter=counter)
    finally:
        km._segments = real
    torch.cuda.synchronize()
    assert idx[0, 0] == 10 and idx[0, 1] == 11
    _, _, offs, slot, tiles = seen[torch.int32]
    sch = km.schedule_plain(idx.cpu().long(), E, km.BM["tile"])
    assert torch.equal(offs.cpu().long(), sch["offsets"])
    assert torch.equal(slot.cpu().long(), sch["slot"])
    t = tiles.view(-1, 3).cpu()
    n = sch["n_used"]
    assert torch.equal(t[:n], sch["tiles"][:n])
    assert (t[n:, 0] == -1).all()


@pytest.mark.parametrize("T", [1, 40, 100])
def test_grouped_kernel_at_widths_off_the_blocks(cuda, T):
    """d and f that the blocks do not divide (boxes and rows past the
    widths), 8 experts; 100 tokens take the tile variant."""
    E, K, D, Fh = 8, 2, 96, 80
    x, logits, (wg, wu, wd) = expert_inputs(cuda, T, E, D, Fh, seed=T)
    counter = torch.zeros(E, dtype=torch.int64, device=cuda)
    out, idx, gates = km.routed_experts(x, logits, wg, wu, wd, top_k=K,
                                        norm_topk=True, scale=2.5,
                                        counter=counter)
    want = km.experts_plain(x, idx.long(), gates, wg, wu, wd)
    torch.testing.assert_close(out, want, rtol=0,
                               atol=2 ** -7 * float(want.abs().max()))


def published(n_layers):
    """DeepSeek-V2-Lite at full width, ``n_layers`` deep (layer 0 dense),
    with the published routing and YaRN."""
    from repro_torch.models.config import _rope_scaling
    return get_config("deepseek-v2-lite-16b").replace(
        n_layers=n_layers, moe_dropless=True, norm_topk_prob=False,
        routed_scaling_factor=1.0, rope_scaling=_rope_scaling(YARN))


def test_prefill_and_decode_never_wait_for_the_host(cuda):
    """A 3-layer copy (1 dense, 2 MoE): a 300-token prefill and a decode
    step under ``set_sync_debug_mode("error")``; the dispatch counts: one
    routing launch and two grouped products a MoE layer a call (tile at
    prefill, small_m at the step), flash_attention's wgmma variant once a
    layer in the prefill; the row counter holds 6 x 301 rows a MoE
    layer."""
    cfg = published(3)
    model = build_model(cfg)
    params = model.init(3, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (1, 300), device=cuda)
    cache = model.init_cache(1, 301, device=cuda)
    torch.cuda.synchronize()
    dispatch.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            logits, cache = model.prefill(params, cache, tokens)
            after_prefill = (dispatch.variant_launches("moe_gemm"),
                             dispatch.launches("moe_route"),
                             dispatch.variant_launches("flash_attention"))
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            logits, cache = model.decode_step(params, cache, tok, 300)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert after_prefill == ({"tile": 4}, 2, {"wgmma": 3})
    assert dispatch.variant_launches("moe_gemm") == {"tile": 4, "small_m": 4}
    assert dispatch.launches("moe_route") == 4
    rows = dispatch.device_counters()[km.ROWS_COUNTER].cpu()
    assert rows[0].sum() == 0 and (rows[1:].sum(1) == 6 * 301).all()
    assert torch.isfinite(logits.float()).all()


def test_mla_prefill_through_wgmma_equals_absorbed(cuda):
    """The decompressed prefill on the card (flash_attention's wgmma
    variant at (192, 128), YaRN on) writes the compressed cache of its
    inputs, and its output agrees with the absorbed form's over that
    cache within bf16 roundings (2**-6
    of the largest magnitude: the two forms round q_c, the scores and P
    at other places).  ``ParamSpec``'s fan-in of a (d, H, 192) weight is
    H, which makes the scores so large that a rounding flips the softmax;
    the test draws them over their input width, as the benchmark does."""
    cfg = published(2)
    model = build_model(cfg)
    params = model.init(4, device=cuda)
    lp = params["dense_layers"][0]["attn"]
    with torch.no_grad():     # the per-head weights over their input width
        lp["q"].mul_((cfg.n_heads / cfg.d_model) ** 0.5)
        lp["uk"].mul_((cfg.n_heads / cfg.kv_lora_rank) ** 0.5)
        lp["uv"].mul_((cfg.n_heads / cfg.kv_lora_rank) ** 0.5)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(1, 1000, cfg.d_model, generator=g,
                    device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        c = attn.mla_init_cache(cfg, 1, 1000, device=cuda)
        before = dispatch.variant_launches("flash_attention")
        o, c = attn.mla_prefill(lp, cfg, x, c)
        n = dispatch.variant_launches("flash_attention")
        assert n.get("wgmma", 0) == before.get("wgmma", 0) + 1
        S = 1000
        positions = torch.arange(S, device=cuda)[None]
        q_nope, q_rope = attn._mla_q(lp, cfg, x, positions)
        c_new, kr_new = attn._mla_ckv(lp, cfg, x, positions)
        assert torch.equal(c["c_kv"], c_new.to(c["c_kv"].dtype))
        assert torch.equal(c["k_rope"], kr_new.to(c["k_rope"].dtype))
        absd = attn.dense(lp["o"], attn._mla_absorbed(
            lp, cfg, q_nope, q_rope, c["c_kv"], c["k_rope"],
            attn.causal_mask(S, S, device=cuda)))
    outs = [o.float(), absd.float()]
    scale = float(outs[1].abs().max())
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=2 ** -6 * scale)
