"""The DeepSeek-V2-Lite cell's own pieces, on the CPU: its counts at
hand-checked shapes, its three readers on hand-made records, its
reference against the port's plain path and against its float8 control,
and a rehearsal of the cell at the smoke config (correct; not correct
when a served token is altered or a decode step keeps its cache)."""

import copy
import dataclasses
import importlib.util
import types

import numpy as np
import pytest
import torch

from portbench import harness, judge, run, weights
from portbench.counts import deepseek_v2, moe_gemm, peaks
from portbench.tests.conftest import ROOT
from repro_torch.kernels import dispatch
from repro_torch.models.common import ParamTree
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model, forward_logits

FULL = "deepseek-v2-lite-16b.prefill-failstop"
SMOKE = "deepseek-v2-lite-smoke"
DS = dict(n_layers=27, n_dense_layers=1, d_model=2048, d_expert=1408,
          n_routed_experts=64, top_k=6)


def test_moe_gemm_bound_at_a_1024_token_prefill():
    """One layer: 64 touched experts x 3 x 2048 x 1408 x 2 B plus the
    1024 input and output rows in bf16, 1,115,684,864 B: 0.333 ms at
    3.35 TB/s, over 0.107 ms of FLOPs; 26 MoE layers."""
    assert moe_gemm.layer_bytes(1024, 2048, 1408, 64, 6) == 1_115_684_864
    assert moe_gemm.layer_ops(1024, 2048, 1408, 6) == 106_300_440_576
    ms, by = peaks.bound_ms(1_115_684_864, 106_300_440_576, peaks.PEAK_BF16)
    assert by == "bytes" and ms == pytest.approx(0.33304, abs=1e-5)
    g = dict(rows=1, S=1024, n=1)
    assert moe_gemm.group_bound_s(DS, g) == pytest.approx(26 * ms / 1e3)


def test_moe_gemm_bound_of_decode_steps():
    """A decode step of one token touches its 6 experts alone."""
    step = moe_gemm.layer_bytes(1, 2048, 1408, 64, 6)
    assert step == 6 * 3 * 2048 * 1408 * 2 + 2 * 2048 * 2
    g = dict(rows=1, S=300, n=4)
    pre = peaks.bound_ms(moe_gemm.layer_bytes(300, 2048, 1408, 64, 6),
                         moe_gemm.layer_ops(300, 2048, 1408, 6),
                         peaks.PEAK_BF16)[0]
    dec = peaks.bound_ms(step, moe_gemm.layer_ops(1, 2048, 1408, 6),
                         peaks.PEAK_BF16)[0]
    assert moe_gemm.group_bound_s(DS, g) == pytest.approx(
        26 * (pre + 3 * dec) / 1e3)


SMALL = dict(n_layers=3, n_dense_layers=1, d_model=8, n_heads=2,
             kv_lora_rank=4, nope_head_dim=3, rope_head_dim=2, v_head_dim=5,
             d_ff=12, d_expert=6, n_routed_experts=4, top_k=2,
             n_shared_experts=1, vocab_size=10)


def test_deepseek_flops_by_hand():
    d, H, c, dn, dr, dv, L, V = 8, 2, 4, 3, 2, 5, 3, 10
    proj = d * H * (dn + dr) + d * (c + dr) + H * dv * d + c * H * (dn + dv)
    ffn = 1 * 3 * d * 12 + 2 * (d * 4 + (2 + 1) * 3 * d * 6)
    per_tok = 2 * (L * proj + ffn)
    S = 4
    prefill = S * per_tok + L * H * 10 * 2 * (dn + dr + dv) + 2 * d * V
    step = per_tok + 2 * d * V
    decode = sum(step + L * H * (S + i) * 2 * (2 * c + dr) for i in (1, 2))
    assert deepseek_v2.request_flops(SMALL, S, 1) == prefill
    assert deepseek_v2.request_flops(SMALL, S, 3) == prefill + decode


def test_the_count_refuses_a_program_without_the_published_fields(
        monkeypatch):
    """A program whose ModelConfig lacks the routing and YaRN fields
    would serve another model: loading the count exits."""
    @dataclasses.dataclass(frozen=True)
    class Old:
        name: str = "model"
        moe: bool = False
    fake = types.ModuleType("repro_torch.models.config")
    fake.ModelConfig = Old
    monkeypatch.setitem(__import__("sys").modules,
                        "repro_torch.models.config", fake)
    path = ROOT / "portbench" / "counts" / "deepseek_v2.py"
    spec = importlib.util.spec_from_file_location("_probe_count", path)
    with pytest.raises(SystemExit, match="cannot serve DeepSeek-V2"):
        spec.loader.exec_module(importlib.util.module_from_spec(spec))


def metric(name):
    return harness.load_module("metrics", name).compute


def test_readers_on_a_hand_made_record():
    groups = [dict(rows=1, S=1024, n=1), dict(rows=1, S=300, n=1)]
    rec = dict(model=DS, trace=dict(
        kernel_s={"moe_gemm": 0.3, "moe_route": 0.05,
                  "flash_attention": 0.1},
        busy_s=0.5, span_s=2.0, groups=groups))
    bound = sum(moe_gemm.group_bound_s(DS, g) for g in groups)
    assert metric("moe_gemm_roofline")(rec) == pytest.approx(
        100 * bound / 0.3)
    assert metric("moe_kernel_share")(rec) == pytest.approx(70.0)
    for tr in (None, dict(kernel_s={"flash_attention": 0.1}, busy_s=0.5,
                          span_s=1.0, groups=groups)):
        assert metric("moe_gemm_roofline")(dict(rec, trace=tr)) is None
        assert metric("moe_kernel_share")(dict(rec, trace=tr)) is None


def test_expert_load_max_reads_the_program_counter():
    read = metric("expert_load_max")
    dispatch.reset_launches()
    rows = dispatch.device_counter("moe_expert_rows", (3, 4), "cpu")
    assert read({}) is None                  # all zero: nothing counted
    rows[1] = torch.tensor([1, 2, 3, 6])
    rows[2] = torch.tensor([3, 3, 3, 3])     # layer 0 dense: no rows
    assert read({}) == pytest.approx(6 / 3)
    dispatch.reset_launches()


def setup(seed=5):
    cj = harness.load_json("configs", SMOKE)
    md = dict(cj["model"], dtype="float32")
    cfg = ModelConfig.from_reference(md)
    model = build_model(cfg)
    w = weights.draw(model.param_specs(), cj["init"], seed, "cpu")
    return model, w, harness.load_module("reference", cj["family"]), md


def test_reference_equals_port_plain_path():
    model, w, ref, md = setup()
    tokens = torch.randint(0, 512, (2, 37),
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = forward_logits(model, ParamTree(w), {"tokens": tokens})
    got = ref.logits(w, md, [t.numpy() for t in tokens],
                     [np.arange(37)] * 2, device="cpu")
    scale = float(want.abs().max())
    for r in range(2):
        torch.testing.assert_close(got[r], want[r].float(), rtol=0,
                                   atol=2e-5 * scale)


def test_ragged_batch_equals_each_alone():
    _, w, ref, md = setup(9)
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 512, size=n) for n in (5, 40, 17)]
    pos = [np.arange(n) for n in (5, 40, 17)]
    together = ref.logits(w, md, seqs, pos, device="cpu")
    for s, p, t in zip(seqs, pos, together):
        alone = ref.logits(w, md, [s], [p], device="cpu")[0]
        torch.testing.assert_close(t, alone, rtol=0, atol=1e-4)


def test_fp8_control_departs():
    _, w, ref, md = setup(2)
    seqs = [np.random.default_rng(3).integers(0, 512, size=60)]
    pos = [np.arange(60)]
    exact = ref.logits(w, md, seqs, pos, device="cpu")
    low = ref.logits(w, md, seqs, pos, precision="fp8", device="cpu")
    assert not torch.allclose(exact[0], low[0], atol=1e-3)
    assert judge.gaps(exact, [lg.argmax(-1).numpy() for lg in low]).max() > 0


def smoke_bench(cell, mix):
    """BENCHMARK.json with the smoke cell reporting what the full one
    does."""
    bench = copy.deepcopy(run.load_benchmark())
    bench["workloads"].append(dict(name=cell, config=SMOKE, traffic=mix,
                                   chips=1))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and FULL in m["workloads"]:
            m["workloads"].append(cell)
    return bench


def test_rehearsal_at_the_smoke_config():
    cell = f"{SMOKE}.prefill-smoke"
    bench = smoke_bench(cell, "prefill-smoke")
    for trace in (False, True):
        r = run.execute(bench, cell, seed=2**33 + 7, seconds=0.3,
                        trace=trace, device="cpu", limits=FULL,
                        forbid=(), log=lambda m: None)
        assert r["correct"] is True, r["checks"]
        assert r["failed"] == 0 and r["readings"]["served_tokens"] >= 1
        want = {m["name"] for m in run.cell_metrics(bench, cell, trace)
                if m["source"] not in run.CPU_SILENT}
        assert set(r["metrics"]) == want
    assert "expert_load_max" in r["metrics"]
    assert r["metrics"]["expert_load_max"]["value"] >= 1.0


@pytest.mark.parametrize("mix,fault", [("prefill-smoke", "token"),
                                       ("decode-smoke", "token"),
                                       ("decode-smoke", "state")])
def test_a_broken_timed_path_is_not_correct(mix, fault):
    cell = f"{SMOKE}.{mix}"
    r = run.execute(smoke_bench(cell, mix), cell, seed=11, seconds=0.2,
                    trace=False, device="cpu", fault=fault, limits=FULL,
                    forbid=(), log=lambda m: None)
    assert r["correct"] is False
    gap = r["checks"]["max_gap"]
    assert gap["value"] > gap["limit"]
