"""The benchmark's frozen copies of ``chip_smoke.py``'s count functions
and peaks give the script's numbers at the shapes the cells time."""

import importlib.util
from pathlib import Path

import pytest

from portbench import traffic
from portbench.counts import flash_attention, flash_decode, peaks
from portbench.counts import wkv6_batched, wkv6_decode

ROOT = Path(__file__).resolve().parents[2]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def mix_sizes(name):
    m = traffic.load(ROOT / "portbench" / "traffic" / f"{name}.json")
    return (sorted(set(traffic.sizes(m["prompt_len"], m["loop_requests"]))),
            sorted(set(traffic.sizes(m["new_tokens"], m["loop_requests"]))))


def spread(sizes):
    """The smallest, middle and largest of a mix's sizes."""
    return [sizes[0], sizes[len(sizes) // 2], sizes[-1]]


DECODE_S = spread(mix_sizes("decode-failstop")[0])
PREFILL_S = spread(mix_sizes("prefill-failstop")[0])


def test_peaks():
    assert (peaks.PEAK_FP32, peaks.PEAK_BF16, peaks.PEAK_BYTES) == (
        chip_smoke.PEAK_FP32, chip_smoke.PEAK_BF16, chip_smoke.PEAK_BYTES)
    for b, o in ((1e6, 1e9), (1e9, 1e6), (0.0, 5e12)):
        for peak in (peaks.PEAK_FP32, peaks.PEAK_BF16):
            assert peaks.bound_ms(b, o, peak) == chip_smoke.bound_ms(b, o,
                                                                      peak)


@pytest.mark.parametrize("S", DECODE_S + PREFILL_S)
def test_flash_decode(S):
    """olmo-1b's decode step at B = 1 over every context of the mixes:
    16 heads of 128, n_valid = S + i slots of an L = S + n cache."""
    for i, n in ((1, 2), (7, 8), (31, 32)):
        nv, L = S + i, S + n
        assert flash_decode.flash_decode_ops(16, nv, 128, 128) == \
            chip_smoke.flash_decode_ops(16, nv, 128, 128)
        # chip_smoke.decode_shape's bytes at B = 1
        want = 2 * (16 * 128 + 2 * 16 * nv * 128 + 16 * 128) + L
        assert flash_decode.step_bytes(1, 16, 16, 128, nv, L) == want


@pytest.mark.parametrize("S", PREFILL_S + DECODE_S)
def test_flash_attention(S):
    """olmo-1b's prefill at B = 1, causal, bf16 (the wgmma variant)."""
    assert flash_attention.attention_ops(1, 16, S, 128, 128, True) == \
        chip_smoke.attention_ops(1, 16, S, 128, 128, True)
    # chip_smoke.attention_shape's bytes: q, k, v, out in bf16, lse f32
    want = 2 * (3 * S * 16 * 128 + 16 * S * 128) + 4 * 16 * S
    assert flash_attention.launch_bytes(1, S, 16, 16, 128, 128) == want


@pytest.mark.parametrize("T", PREFILL_S + DECODE_S)
def test_wkv6(T):
    """rwkv6-1.6b: 32 heads of 64 a request, chunk 32."""
    assert wkv6_batched.wkv6_batched_ops(32, T, 64, 64, 32) == \
        chip_smoke.wkv6_batched_ops(32, T, 64, 64, 32)
    assert wkv6_batched.wkv6_batched_bound(32, T, 64, 64, 32) == \
        chip_smoke.wkv6_batched_bound(32, T, 64, 64, 32)
    for BH in (32, 64, 256):
        assert wkv6_decode.wkv6_decode_bound(BH, 64, 64) == \
            chip_smoke.wkv6_decode_bound(BH, 64, 64)


def test_group_bounds_sum_the_launches():
    olmo = dict(n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16)
    g = dict(rows=1, S=100, n=3)
    steps = [chip_smoke.bound_ms(
        2 * (16 * 128 + 2 * 16 * (100 + i) * 128 + 16 * 128) + 103,
        chip_smoke.flash_decode_ops(16, 100 + i, 128, 128))[0]
        for i in (1, 2)]
    assert flash_decode.group_bound_s(olmo, g) == pytest.approx(
        16 * sum(steps) / 1e3)
    rw = dict(n_layers=24, d_model=2048, rwkv_head_dim=64)
    assert wkv6_decode.group_bound_s(rw, dict(rows=2, S=5, n=4)) == \
        pytest.approx(24 * 3 * chip_smoke.wkv6_decode_bound(64, 64, 64)[0]
                      / 1e3)
    assert wkv6_batched.group_bound_s(rw, dict(rows=1, S=1000, n=1)) == \
        pytest.approx(24 * chip_smoke.wkv6_batched_bound(
            32, 1000, 64, 64, 32)[0] / 1e3)
