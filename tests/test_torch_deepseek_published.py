"""DeepSeek-V2's published math in the port, on the CPU: the dropless
top-k routing (``models/moe.py``, ``kernels/moe.py``'s plain versions),
YaRN's RoPE and softmax scale (``models/common.py``,
``models/attention.py``), at deepseek-v2-lite-smoke's widths with the
published fields on, against the benchmark's plain float32 reference
(``portbench/reference/deepseek_v2.py``); and, with the fields off, the
GShard path and plain RoPE as they were.

Tolerances: the port in float32 against the reference within 1e-4 of
the largest logit: both compute in float32, but the port's prefill and
decode attend in the absorbed form over the compressed cache where the
reference expands it, and the experts' and heads' sums add in other
orders (measured gaps are near 1e-6 of the scale).  The routing against
a per-token loop within 1e-5 of the output's scale (float32 products in
other orders).
"""

import math
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, weights  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import moe as km  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    ParamTree, apply_rope, apply_rope_prefix, rope_freqs, yarn_mscale)
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.moe import moe_apply  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

SMOKE = "deepseek-v2-lite-smoke"


def smoke(seed=5, dtype="float32"):
    cj = harness.load_json("configs", SMOKE)
    md = dict(cj["model"], dtype=dtype)
    cfg = ModelConfig.from_reference(md)
    model = build_model(cfg)
    w = weights.draw(model.param_specs(), cj["init"], seed, "cpu")
    ref = harness.load_module("reference", cj["family"])
    return cfg, model, w, ref, md


def test_the_smoke_config_states_the_published_math():
    cfg, *_ = smoke()
    assert cfg.moe_dropless and not cfg.norm_topk_prob
    assert cfg.routed_scaling_factor == 1.0
    assert cfg.yarn == {"beta_fast": 32.0, "beta_slow": 1.0, "factor": 40.0,
                        "mscale": 0.707, "mscale_all_dim": 0.707,
                        "original_max_position_embeddings": 4096.0}


@pytest.mark.parametrize("seed", [5, 11])
def test_prefill_then_decode_equals_the_reference(seed):
    """Prefill of 23 tokens, then 9 greedy steps through the cache: the
    logits at every served position against the reference's full
    forward over the prompt and the served tokens."""
    cfg, model, w, ref, md = smoke(seed)
    params = ParamTree(w)
    S, n = 23, 10
    prompt = torch.randint(0, cfg.vocab_size, (1, S),
                           generator=torch.Generator().manual_seed(seed))
    got, toks = [], []
    with torch.inference_mode():
        cache = model.init_cache(1, S + n, device="cpu")
        lg, cache = model.prefill(params, cache, prompt)
        for i in range(n):
            got.append(lg[0, -1])
            tok = torch.argmax(lg[:, -1], -1)
            toks.append(int(tok))
            if i + 1 < n:
                lg, cache = model.decode_step(params, cache, tok[:, None],
                                              S + i)
    seq = np.concatenate([prompt[0].numpy(), toks[:-1]])
    want = ref.logits(w, md, [seq], [np.arange(S - 1, S + n - 1)],
                      device="cpu")[0]
    got = torch.stack(got)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)


def _forms(lp, cfg, x, cache):
    """Both forms of MLA's prefill attention over the compressed cache
    that ``mla_prefill`` wrote: (decompressed, absorbed) outputs."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    q_nope, q_rope = attn._mla_q(lp, cfg, x, positions)
    ck, kr = cache["c_kv"][:, :S], cache["k_rope"][:, :S]
    dec = attn._mla_decompressed(lp, cfg, q_nope, q_rope, ck, kr)
    absd = attn._mla_absorbed(lp, cfg, q_nope, q_rope, ck, kr,
                              attn.causal_mask(S, S, device=x.device))
    return attn.dense(lp["o"], dec), attn.dense(lp["o"], absd)


def test_decompressed_prefill_equals_absorbed():
    """The card's prefill form, run here on the CPU's plain attention,
    against the absorbed form that ``mla_prefill`` takes on the CPU: the
    same output within float32 rounding, over the cache it wrote."""
    cfg, model, w, *_ = smoke(3)
    lp = ParamTree(w)["dense_layers"][0]["attn"]
    x = torch.randn(2, 31, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        c = attn.mla_init_cache(cfg, 2, 40, device="cpu")
        o, c = attn.mla_prefill(lp, cfg, x, c)
        dec, absd = _forms(lp, cfg, x, c)
    assert torch.equal(o, absd)
    torch.testing.assert_close(dec, absd, rtol=0,
                               atol=1e-5 * float(absd.abs().max()))


def per_token(x, logits, wg, wu, wd, K, norm, scale):
    """The published layer token by token, float64."""
    out = torch.zeros(x.shape, dtype=torch.float64)
    for t in range(x.shape[0]):
        p = torch.softmax(logits[t].double(), -1)
        order = sorted(range(p.numel()), key=lambda e: (-float(p[e]), e))
        top = order[:K]
        g = p[top]
        if norm:
            g = g / g.sum()
        for e, ge in zip(top, g * scale):
            xe = x[t].double()
            h = torch.nn.functional.silu(xe @ wg[e].double()) * (
                xe @ wu[e].double())
            out[t] += ge * (h @ wd[e].double())
    return out


@pytest.mark.parametrize("norm,scale", [(False, 1.0), (True, 2.5)])
def test_dropless_routing_against_a_per_token_loop(norm, scale):
    """8 experts, top 3, every token kept: expert 6 routed none, and token
    0 ties experts 2 and 4 at the top (the lower first)."""
    E, K, D, Fh, T = 8, 3, 16, 12, 40
    g = torch.Generator().manual_seed(7)
    x = torch.randn(T, D, generator=g)
    logits = torch.randn(T, E, generator=g)
    logits[:, 6] = -30.0
    logits[0, 2] = logits[0, 4] = 9.0
    wg, wu = (torch.randn(E, D, Fh, generator=g) for _ in range(2))
    wd = torch.randn(E, Fh, D, generator=g)
    counter = torch.zeros(E, dtype=torch.int64)
    out, idx, gates = km.routed_experts(x, logits, wg, wu, wd, top_k=K,
                                        norm_topk=norm, scale=scale,
                                        counter=counter)
    assert idx[0, :2].tolist() == [2, 4]
    assert counter[6] == 0 and int(counter.sum()) == T * K
    want = per_token(x, logits, wg, wu, wd, K, norm, scale)
    torch.testing.assert_close(out.double(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    sch = km.schedule_plain(idx, E, 4)
    assert sch["counts"].tolist() == counter.tolist()
    tiles = sch["tiles"][:sch["n_used"]]
    assert 6 not in tiles[:, 0].tolist()
    rows = torch.cat([torch.arange(int(a), int(b)) for _, a, b in tiles])
    assert torch.equal(rows, torch.arange(T * K))      # each row once
    flat = idx.reshape(-1)[sch["slot"]]
    assert (flat[1:] >= flat[:-1]).all()               # experts in order


def test_moe_apply_dropless_adds_the_shared_experts():
    cfg = get_smoke("deepseek-v2-lite-16b").replace(
        dtype="float32", moe_dropless=True, norm_topk_prob=False)
    model = build_model(cfg)
    p = model.init(2, device="cpu")["moe_layers"][0]["ffn"]
    x = torch.randn(2, 7, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        out, aux = moe_apply(p, cfg, x, layer=1)
    xt = x.reshape(14, -1)
    w = p["experts"]
    want = per_token(xt, xt @ p["router"], w["gate"], w["up"], w["down"],
                     cfg.top_k, False, 1.0)
    sh = p["shared"]
    want += (torch.nn.functional.silu(xt @ sh["gate"]) * (xt @ sh["up"])
             @ sh["down"]).double()
    torch.testing.assert_close(out.reshape(14, -1).double(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    assert float(aux) == 0.0                   # a serving path: no aux loss


YARN = (("beta_fast", 32.0), ("beta_slow", 1.0), ("factor", 40.0),
        ("mscale", 0.707), ("mscale_all_dim", 0.707),
        ("original_max_position_embeddings", 4096.0))


def published_inv_freq(dim, base, factor, orig, beta_fast, beta_slow):
    """DeepSeek-V2's modeling code, written out again."""
    def corr_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (
            2 * math.log(base))
    low = max(math.floor(corr_dim(beta_fast)), 0)
    high = min(math.ceil(corr_dim(beta_slow)), dim - 1)
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2,
                                              dtype=torch.float32) / dim))
    freq_inter = 1.0 / (factor * base ** (
        torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask, (low, high)


def test_yarn_frequencies_and_scale():
    got = rope_freqs(64, 10000.0, yarn=YARN)
    want, (low, high) = published_inv_freq(64, 10000.0, 40, 4096, 32, 1)
    assert (low, high) == (10, 23)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    plain = rope_freqs(64, 10000.0)
    assert torch.equal(got[:11], plain[:11])                # pairs 0-10
    torch.testing.assert_close(got[23:], plain[23:] / 40, rtol=1e-6, atol=0)
    mid = got[11:23]                                        # they blend
    assert ((mid < plain[11:23]) & (mid > plain[11:23] / 40)).all()
    m = yarn_mscale(40, 0.707)
    assert m == pytest.approx(0.1 * 0.707 * math.log(40) + 1)
    assert m == pytest.approx(1.2608, abs=1e-4)
    cfg = get_config("deepseek-v2-lite-16b").replace(rope_scaling=YARN)
    assert attn.mla_scale(cfg) == pytest.approx(192 ** -0.5 * m * m)
    ref = harness.load_module("reference", "deepseek_v2")
    torch.testing.assert_close(ref.yarn_inv_freq(64, 10000.0, dict(YARN)),
                               want, rtol=1e-6, atol=0)


def test_published_fields_off_leave_every_config_as_it_was():
    """Defaults: the GShard path, renormalised gates, plain RoPE; olmo's
    frequencies and rotation bit for bit the formula they had."""
    cfg = ModelConfig()
    assert (cfg.moe_dropless, cfg.norm_topk_prob,
            cfg.routed_scaling_factor, cfg.rope_scaling) == (
                False, True, 1.0, ())
    assert cfg.yarn is None
    olmo = get_config("olmo-1b")
    assert olmo.rope_scaling == () and not olmo.moe_dropless
    dim = olmo.head_dim
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    assert torch.equal(rope_freqs(dim, olmo.rope_theta),
                       1.0 / (olmo.rope_theta ** exps))
    x = torch.randn(2, 9, 4, dim, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(9)[None].expand(2, 9)
    ang = pos[..., None].float() * (1.0 / (olmo.rope_theta ** exps))
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    want = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    assert torch.equal(apply_rope(x, pos, olmo.rope_theta), want)
    ds = get_config("deepseek-v2-lite-16b")
    assert not ds.moe_dropless and attn.mla_scale(ds) == 192 ** -0.5


def test_rope_scaling_from_a_published_dict():
    cfg = ModelConfig.from_reference(
        {"rope_scaling": dict(YARN, type="yarn")})
    assert cfg.rope_scaling == YARN
    with pytest.raises(ValueError, match="only yarn"):
        ModelConfig.from_reference({"rope_scaling": {"type": "linear",
                                                     "factor": 2.0}})


def test_device_counter_zeroed_with_the_launch_counts():
    c = dispatch.device_counter("probe_rows", (2, 3), "cpu")
    c += 5
    assert dispatch.device_counter("probe_rows", (2, 3), "cpu") is c
    assert int(dispatch.device_counters()["probe_rows"].sum()) == 30
    dispatch.reset_launches()
    assert int(c.sum()) == 0
    assert dispatch.device_counter("probe_rows", (3, 3), "cpu").shape == (3, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("yarn", [(), "published"])
@pytest.mark.parametrize("heads", [True, False])
def test_rope_prefix_equals_rope_at_positions(dtype, yarn, heads):
    """The prefill's table RoPE equals apply_rope at positions 0..S-1 bit
    for bit (one product each and one sum a half, in float32), with and
    without YaRN and a head axis."""
    yarn = YARN if yarn else ()
    g = torch.Generator().manual_seed(3)
    shape = (2, 37, 4, 64) if heads else (2, 37, 64)
    x = torch.randn(shape, generator=g).to(dtype) * 3
    pos = torch.arange(37)[None].expand(2, 37)
    want = apply_rope(x, pos, 10000.0, yarn)
    got = apply_rope_prefix(x, 10000.0, yarn, heads=heads)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("case", ["experts", "top_k", "width", "dtype"])
def test_kernel_launcher_refuses_what_it_cannot_take(case):
    """The CUDA wrapper's checks, which run before any launch: at most 64
    experts and 8 a token, widths a multiple of 8, bfloat16 operands."""
    E, K, D, Fh = 64, 6, 64, 32
    if case == "experts":
        E = 128
    if case == "top_k":
        K = 9
    if case == "width":
        Fh = 36
    dt = torch.float32 if case == "dtype" else torch.bfloat16
    x = torch.zeros(5, D, dtype=dt)
    w = [torch.zeros(E, a, b, dtype=dt) for a, b in ((D, Fh), (D, Fh),
                                                     (Fh, D))]
    logits = torch.zeros(5, E)
    counter = torch.zeros(E, dtype=torch.int64)
    with pytest.raises(ValueError):
        km._check(x, logits, *w, counter, K)
    if case == "dtype":          # the same shapes in bfloat16 pass
        km._check(x.bfloat16(), logits, *(t.bfloat16() for t in w),
                  counter, K)
