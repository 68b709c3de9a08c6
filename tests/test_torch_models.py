"""The port's models (``repro_torch.models``, on the CPU, the kernels'
plain versions underneath) against the JAX package's, with the weights
carried across by ``params_from_reference``.

Tolerances, each with its reason: logits within 1e-4 absolute plus 1e-5
relative.  The configs are float32 (as ``tests/test_decode_fused.py``
uses them); the two frameworks sum matrix products and softmaxes in
other orders, and the chunked WKV6 takes another (pairwise) form, so
they agree to float32 rounding and not bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import rwkv6 as jrwkv6
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_reference

# the dense and rwkv entries of CONFIGS in tests/test_decode_fused.py,
# the served archs' smoke configs, qwen3's (qk-norm) and qwen2's (QKV
# bias) in float32, and a dense config with a rolling window
JCONFIGS = {
    "dense": JModelConfig(family="dense", n_layers=2, d_model=64, n_heads=2,
                          n_kv_heads=2, d_ff=128, vocab_size=128,
                          dtype="float32"),
    "rwkv": JModelConfig(family="rwkv", n_layers=2, d_model=64, n_heads=2,
                         d_ff=128, vocab_size=128, dtype="float32",
                         rwkv_head_dim=16),
    "olmo-smoke": jget_smoke("olmo-1b").replace(dtype="float32"),
    "qwen3-smoke": jget_smoke("qwen3-4b").replace(dtype="float32"),
    "qwen2-smoke": jget_smoke("qwen2-72b").replace(dtype="float32"),
    "rwkv6-smoke": jget_smoke("rwkv6-1.6b").replace(dtype="float32"),
    "window": JModelConfig(family="dense", n_layers=2, d_model=64, n_heads=4,
                           n_kv_heads=2, d_ff=128, vocab_size=128,
                           dtype="float32", sliding_window=8),
}


def pair(key):
    """(reference model, its params, port model, port params)."""
    jcfg = JCONFIGS[key]
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(ModelConfig.from_reference(jcfg))
    tp = params_from_reference(tm, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    return jm, jp, tm, tp


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("key", list(JCONFIGS))
def test_prefill_and_decode_logits_match_jax(key):
    """prefill over a 37-token prompt (two rwkv chunks, the last ragged;
    past the window of "window"), then 5 decode steps fed the
    reference's greedy tokens."""
    jm, jp, tm, tp = pair(key)
    B, S, steps = 2, 37, 5
    vocab = JCONFIGS[key].vocab_size
    prompts = np.random.default_rng(1).integers(
        0, vocab, (B, S)).astype(np.int32)
    jcache = jm.init_cache(B, S + steps)
    tcache = tm.init_cache(B, S + steps, device="cpu")
    jl, jcache = jax.jit(jm.prefill)(jp, jcache, prompts)
    jdecode = jax.jit(jm.decode_step)
    with torch.inference_mode():
        tl, tcache = tm.prefill(tp, tcache, torch.from_numpy(prompts))
        _close(tl, jl)
        for pos in range(S, S + steps):
            tok = np.array(jax.numpy.argmax(jl[:, -1], -1),
                           np.int32)[:, None]
            jl, jcache = jdecode(jp, jcache, tok, pos)
            tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok),
                                        pos)
            assert tl.shape == (B, 1, vocab)
            _close(tl, jl)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    """The copied configs equal the reference's, field for field, and
    ``from_reference`` takes both the object and its asdict."""
    for tget, jget in ((tconfigs.get_config, jget_config),
                       (tconfigs.get_smoke, jget_smoke)):
        ref = jget(arch)
        assert tget(arch) == ModelConfig.from_reference(ref)
        assert tget(arch) == ModelConfig.from_reference(
            dataclasses.asdict(ref))
    assert tconfigs.applicable_shapes(tconfigs.get_config(arch)) == [
        *tconfigs.SHAPES][:4 if tconfigs.get_config(arch).subquadratic
                          else 3]


def test_param_dtype_is_torch():
    assert tconfigs.get_config("olmo-1b").param_dtype == torch.bfloat16
    assert JCONFIGS["dense"].dtype == "float32"
    assert ModelConfig(dtype="float32").param_dtype == torch.float32


@pytest.mark.parametrize("arch,family", [
    ("deepseek-v3-671b", "moe"), ("paligemma-3b", "vlm"),
    ("whisper-tiny", "encdec"), ("hymba-1.5b", "hybrid")])
def test_unported_families_name_their_roadmap_item(arch, family):
    """The families that ROADMAP.md's item A6 listed as unported now
    build, each as the reference's model class of the same name."""
    cfg = tconfigs.get_smoke(arch)
    assert cfg.family == family
    model = build_model(cfg)
    assert type(model).__name__ == type(jbuild(jget_smoke(arch))).__name__


def test_unported_paths_raise():
    """The paths that raised until item A6 was ported now run: MLA on a
    dense-family config builds, and a windowed mask at ``flash_threshold``
    tokens takes the chunked ``flash_attend``, whose logits equal the
    dense ``_attend``'s (the same config at a threshold above S) within
    float32 rounding; a plain causal mask at the threshold runs through
    the flash attention kernel's path."""
    assert build_model(ModelConfig(family="dense", mla=True)).cfg.mla
    cfg = ModelConfig(family="dense", n_layers=1, d_model=16, n_heads=2,
                      n_kv_heads=2, d_ff=32, vocab_size=32, dtype="float32",
                      flash_threshold=8, sliding_window=4)
    m = build_model(cfg)
    p = m.init(0, device="cpu")
    tokens = torch.arange(8, dtype=torch.int32)[None] % 32
    chunked, _, _ = m.forward(p, tokens)
    dense_, _, _ = build_model(cfg.replace(flash_threshold=9)).forward(
        p, tokens)
    np.testing.assert_allclose(chunked.detach().numpy(),
                               dense_.detach().numpy(), atol=1e-5)
    logits, _, _ = build_model(cfg.replace(sliding_window=0)).forward(
        p, tokens)
    assert logits.shape == (1, 8, 32) and bool(torch.isfinite(logits).all())


def test_init_draws_the_reference_distributions():
    """normal: fan-in std (embed: 1); zeros, ones exact; seeded."""
    g = torch.Generator().manual_seed(0)
    x = ParamSpec((512, 256), dtype=torch.float32).materialize(g, "cpu")
    assert abs(float(x.std()) - 512 ** -0.5) < 0.01 * 512 ** -0.5
    e = ParamSpec((512, 256), init="embed",
                  dtype=torch.float32).materialize(g, "cpu")
    assert abs(float(e.std()) - 1.0) < 0.01
    assert ParamSpec((3,), init="ones").materialize(g, "cpu").tolist() == [
        1.0, 1.0, 1.0]
    m = build_model(tconfigs.get_smoke("olmo-1b"))
    a, b = m.init(3, device="cpu"), m.init(3, device="cpu")
    for x, y in zip(a.parameters(), b.parameters()):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y)


def test_convert_keeps_bf16_bits_and_checks_shapes():
    jcfg = jget_smoke("olmo-1b")
    jm = jbuild(jcfg)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    tm = build_model(ModelConfig.from_reference(jcfg))
    tp = params_from_reference(tm, jp, device="cpu")
    got = tp["dense_layers"][1]["ffn"]["up"]
    assert got.dtype == torch.bfloat16
    want = jp["dense_layers"]["ffn"]["up"][1]
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))
    jp["embed"] = jp["embed"][:, :8]
    with pytest.raises(ValueError, match="embed"):
        params_from_reference(tm, jp, device="cpu")


@pytest.mark.parametrize("T", [32, 37])
def test_wkv6_model_twins_match_reference(T):
    """``wkv6_sequential`` equals the reference's; ``wkv6_chunked`` (any
    T, pairwise decays) matches it too.  float32: 1e-4 of the scale."""
    rng = np.random.default_rng(T)
    r, k, v = (rng.standard_normal((T, 8), dtype=np.float32)
               for _ in range(3))
    w = rng.uniform(0.05, 1.0, (T, 8)).astype(np.float32)
    u = rng.standard_normal(8, dtype=np.float32)
    s = rng.standard_normal((8, 8), dtype=np.float32)
    want_y, want_s = (np.asarray(a) for a in jrwkv6.wkv6_sequential(
        r, k, v, w, u, s))
    args = [torch.from_numpy(a) for a in (r, k, v, w, u, s)]
    scale = np.abs(want_y).max()
    for fn in (trwkv6.wkv6_sequential, trwkv6.wkv6_chunked):
        y, st = fn(*args)
        np.testing.assert_allclose(y.numpy(), want_y, atol=1e-4 * scale)
        np.testing.assert_allclose(st.numpy(), want_s,
                                   atol=1e-4 * np.abs(want_s).max())


@pytest.mark.parametrize("scores_bf16", [False, True])
def test_attend_matches_reference(scores_bf16):
    """Full-sequence attention with a sliding-window causal mask; the
    bf16-scores variant rounds probabilities to bfloat16 (2^-8), so it
    is held within 1e-2, the float32 one within 1e-5."""
    rng = np.random.default_rng(int(scores_bf16))
    q, k, v = (rng.standard_normal((2, 9, 4, 16), dtype=np.float32)
               for _ in range(3))
    want = np.asarray(jattn._attend(q, k, v, jattn.causal_mask(9, 9,
                                                               window=4),
                                    0.25, scores_bf16=scores_bf16))
    got = tattn._attend(*(torch.from_numpy(a) for a in (q, k, v)),
                        tattn.causal_mask(9, 9, window=4), 0.25,
                        scores_bf16=scores_bf16)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-2 if scores_bf16 else 1e-5)
