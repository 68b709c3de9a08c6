"""The port's step API and dry run (``repro_torch.launch.{steps,
op_analysis,dryrun,mesh}``, ``repro_torch.distributed``,
``configs.input_specs``/``train_config``) on the CPU, against the JAX
package.

Tolerances: input specs, train settings and the logical-axis rules are
compared exactly; one training step (float32 smoke config, 2
microbatches, adamw): loss, gradient norm and parameters within 1e-5
(the parameters but for at most 1e-4 of them, see the test); the dry
run's FLOPs within 1% of a closed form written here from the model's
shapes.
"""

import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import batch_for_step as jbatch_for_step
from repro.distributed import partitioner as jpart
from repro.launch import steps as jsteps
from repro.launch.mesh import make_host_mesh
from repro_torch import configs, trips
from repro_torch.configs import SHAPES, Shape
from repro_torch.data import as_tensors, batch_for_step
from repro_torch.distributed import partitioner
from repro_torch.kernels import dispatch
from repro_torch.launch import dryrun, mesh, op_analysis, steps
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import params_from_reference

SRC = Path(__file__).resolve().parents[1] / "src"
CELLS = [(a, s) for a in configs.ARCH_IDS
         for s in configs.applicable_shapes(configs.get_config(a))]


def _numel_by_dtype(leaves) -> dict:
    out: dict = {}
    for shape, dtype in leaves:
        out[dtype] = out.get(dtype, 0) + int(np.prod(shape, dtype=np.int64))
    return out


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


# ------------------------------------------------------------ input specs
@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_reference(arch, shape):
    """Every input's shape and dtype equals the reference's
    ShapeDtypeStruct; a decode cache (stacked over layers in the
    reference, a list per layer here) holds the same elements of each
    dtype.  All on ``meta``."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    got = configs.input_specs(cfg, SHAPES[shape])
    want = jconfigs.input_specs(jcfg, jconfigs.SHAPES[shape])
    assert set(got) == set(want)
    for key in want:
        if key == "cache":
            g = [(tuple(t.shape), _dtype_name(t.dtype))
                 for t in tree_leaves(got[key])]
            w = [(tuple(x.shape), str(x.dtype))
                 for x in jax.tree_util.tree_leaves(want[key])]
            assert _numel_by_dtype(g) == _numel_by_dtype(w)
            assert all(t.is_meta for t in tree_leaves(got[key]))
            continue
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert _dtype_name(got[key].dtype) == str(want[key].dtype), key
        assert got[key].is_meta


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_config_equals_reference(arch):
    assert configs.train_config(arch) == jconfigs.train_config(arch)


def test_meta_params_are_abstract():
    """Parameters on ``meta`` are drawn from nothing and hold no memory;
    their shapes and dtypes are the seeded init's."""
    cfg = configs.get_smoke("olmo-1b")
    model = build_model(cfg)
    meta = model.init(0, device="meta")
    real = model.init(0, device="cpu")
    for m, r in zip(tree_leaves(meta), tree_leaves(real)):
        assert m.is_meta and m.shape == r.shape and m.dtype == r.dtype


# ------------------------------------------------------------ partitioner
AXES = [("batch", None, "embed"), ("embed", "mlp"), ("heads", "embed"),
        ("vocab", "embed"), ("expert", "embed", "expert_mlp"),
        ("batch", "cache_seq", "kv_heads", None), ("layers", "embed"),
        ("batch", "seq", "act_embed"), (None, None)]
SHAPES_OF = {2: (4096, 1024), 3: (256, 4096, 2048), 4: (128, 32768, 8, 128)}
MESHES = [None, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}, {"data": 1, "model": 1}]


@pytest.mark.parametrize("kw", [{}, {"fsdp": True}, {"seq_shard": True},
                                {"expert_mlp_shard": True},
                                {"fsdp": True, "overrides": {
                                    "batch": ("pod", "data", "model"),
                                    "heads": None}}])
def test_axis_rules_equal_reference(kw):
    """make_rules and AxisRules.spec resolve every logical axis as the
    reference does, with and without a mesh (divisibility fallback
    included); a mesh is its ``{axis: size}`` shape here."""
    rules = partitioner.make_rules(**kw)
    assert rules == jpart.make_rules(**kw)
    got_rules = partitioner.AxisRules(rules)
    want_rules = jpart.AxisRules(rules)
    for axes in AXES:
        shape = SHAPES_OF.get(len(axes), (6,) * len(axes))
        for m in MESHES:
            jmesh = None if m is None else types.SimpleNamespace(shape=m)
            want = tuple(want_rules.spec(axes, shape, jmesh))
            assert got_rules.spec(axes, shape, m) == want, (axes, m)
            odd = tuple(s + 1 for s in shape)     # not divisible
            assert got_rules.spec(axes, odd, m) == tuple(
                want_rules.spec(axes, odd, jmesh))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_step_partitioner_rules_equal_reference(arch):
    """Each arch's rule set (its parallelism and fsdp) is the
    reference's; on one device constraints are the identity."""
    got = steps.make_partitioner(configs.get_config(arch))
    want = jsteps.make_partitioner(jconfigs.get_config(arch), None)
    assert dict(got.rules.rules) == dict(want.rules.rules)
    x = torch.ones(2, 3)
    assert partitioner.logical_constraint(x, ("batch", "embed")) is x
    assert got.constrain(x, ("batch", "embed")) is x


def test_card_peaks_are_the_spec_sheet():
    assert mesh.PEAK_FLOPS_BF16 == 989e12 and mesh.HBM_BW == 3.35e12
    assert mesh.HBM_BYTES == 80e9
    terms = op_analysis.roofline_terms(2e12, 6.7e10, peak_flops=1e12,
                                       hbm_bw=3.35e10)
    assert terms == {"t_compute": 2.0, "t_memory": 2.0}
    assert op_analysis.dominant_term({"t_compute": 1.0,
                                      "t_memory": 3.0}) == "t_memory"


# ------------------------------------------------------------------ steps
def test_train_step_equals_reference():
    """One TrainStep (float32 smoke config, 2 microbatches, adamw,
    clipping) against the reference's make_train_step on a one-device
    host mesh, from the same weights and batch: loss and gradient norm
    within 1e-5, and the updated parameters within 1e-5 but for at most
    1e-4 of them, those within a tenth of the learning rate (adamw's
    first step moves each by about lr g / |g|, so where a gradient is
    near its eps the two frameworks' roundings move the update
    visibly: 2 of 174,080 here)."""
    jcfg = jconfigs.get_smoke("olmo-1b").replace(dtype="float32")
    cfg = configs.get_smoke("olmo-1b").replace(dtype="float32")
    hmesh = make_host_mesh()
    with hmesh:
        jts = jsteps.make_train_step(jcfg, hmesh, num_microbatches=2,
                                     optimizer="adamw", lr=1e-3)
        jp = jts.model.init(jax.random.PRNGKey(0))
        jbatch = jbatch_for_step(jcfg, 0, 4, 16)
        jp2, _, jm = jts.step_fn(jp, jts.opt.init(jp), jbatch)
    ts = steps.make_train_step(cfg, num_microbatches=2, optimizer="adamw",
                               lr=1e-3)
    tp = params_from_reference(ts.model, jax.tree_util.tree_map(
        np.asarray, jp), device="cpu")
    tp2, _, tm = ts(tp, ts.opt.init(tp),
                    as_tensors(batch_for_step(cfg, 0, 4, 16), "cpu"))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
        float(jm["loss"]))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5 * (
        float(jm["grad_norm"]))
    want = params_from_reference(ts.model, jax.tree_util.tree_map(
        np.asarray, jp2), device="cpu")
    diffs = [(a - b).abs() for a, b in zip(tree_leaves(tp2),
                                           tree_leaves(want))]
    n = sum(d.numel() for d in diffs)
    assert sum(int((d > 1e-5).sum()) for d in diffs) <= 1e-4 * n
    assert max(float(d.max()) for d in diffs) <= 0.1 * 1e-3


@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-1.6b", "hymba-1.5b"])
def test_serve_step_equals_reference(arch):
    """ServeStep's prefill logits (within 1e-4 + 1e-5) and greedy decode
    token (equal) against the reference's make_serve_step."""
    jcfg = jconfigs.get_smoke(arch).replace(dtype="float32")
    cfg = configs.get_smoke(arch).replace(dtype="float32")
    hmesh = make_host_mesh()
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    with hmesh:
        jss = jsteps.make_serve_step(jcfg, hmesh)
        jp = jss.model.init(jax.random.PRNGKey(0))
        jlogits = jss.prefill_fn(jp, {"tokens": tokens})
        jcache = jss.model.init_cache(2, 16)
        jtok, _ = jss.decode_fn(jp, jcache, tokens[:, :1], 0)
    ss = steps.make_serve_step(cfg)
    tp = params_from_reference(ss.model, jax.tree_util.tree_map(
        np.asarray, jp), device="cpu")
    logits = ss.prefill_fn(tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    tok, _ = ss.decode_fn(tp, ss.model.init_cache(2, 16, device="cpu"),
                          torch.from_numpy(tokens[:, :1]), 0)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


# -------------------------------------------------------------- dry run
def test_dryrun_olmo_smoke_train_flops_closed_form():
    """olmo smoke, one training step on meta: every matrix product of a
    layer runs in the forward, again in the rematerialised forward (but
    the down projection, whose output the backward does not need: the
    recomputation stops before it) and twice in the backward; the tied
    head in the forward and twice in the backward; attention (one
    backward tile: S <= 512) 4 S^2 d in each forward and 10 S^2 d in
    the backward."""
    cfg = configs.get_smoke("olmo-1b")
    B, S = 4, 64
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    assert cfg.n_kv_heads == cfg.n_heads and cfg.act == "silu"
    p_layer = 4 * d * d + 3 * d * f
    per_token = L * (8 * p_layer - 2 * d * f) + 6 * d * V
    closed = B * S * per_token + B * L * d * 18 * S * S
    rec = dryrun.measure(cfg, Shape("t", S, B, "train"), microbatches=2)
    assert abs(rec["flops"] - closed) <= 0.01 * closed, (rec["flops"],
                                                         closed)


def test_dryrun_rwkv6_smoke_decode_flops_closed_form():
    """rwkv6 smoke, one decode step: per token and layer five d x d
    projections and six LoRAs (d x 32 x d: one in each of the five
    lerps, and the decay's own) in the time mix, d x f, f x d and d x d
    in the channel mix; the head; the recurrence's step is elementwise
    (no FLOPs counted)."""
    cfg = configs.get_smoke("rwkv6-1.6b")
    B = 3
    d, f, V, L, R = (cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers,
                     32)
    per_token = L * (10 * d * d + 24 * d * R + 4 * d * f + 2 * d * d) \
        + 2 * d * V
    closed = B * per_token
    rec = dryrun.measure(cfg, Shape("d", 64, B, "decode"))
    assert abs(rec["flops"] - closed) <= 0.01 * closed, (rec["flops"],
                                                         closed)


def test_trips_count_one_trip_times_n():
    """A loop over trips(n) under an op count runs one trip with the
    multiplier n: rwkv6's chunked prefill counts as the full loop does
    (within 1%: its last chunk is as long as the others here)."""
    cfg = configs.get_smoke("rwkv6-1.6b")
    shape = Shape("p", 256, 2, "prefill")
    counted = dryrun.measure(cfg, shape)
    with torch.enable_grad():     # every trip runs under autograd
        ss = steps.make_serve_step(cfg)
        params = ss.model.init(0, device="meta")
        specs = configs.input_specs(cfg, shape)
        with op_analysis.Counter() as full:
            ss.prefill_fn(params, specs)
    assert abs(counted["flops"] - full.flops) <= 0.01 * full.flops
    assert abs(counted["unfused_bytes"] - full.unfused_bytes) \
        <= 0.01 * full.unfused_bytes
    assert list(trips.trips(3)) == [0, 1, 2]
    assert trips.full([1], 3) == [1, 1, 1]


def test_wrappers_take_their_plain_versions_on_meta():
    """Every kernel wrapper on a meta tensor runs its plain version:
    no launch, no error, the path recorded as torch."""
    from repro_torch.kernels import ops
    dispatch.reset_launches()
    m = dict(device="meta")
    ops.flash_attention_gqa(torch.empty(1, 8, 2, 16, **m),
                            torch.empty(1, 8, 1, 16, **m),
                            torch.empty(1, 8, 1, 16, **m))
    ops.flash_decode_gqa(torch.empty(1, 2, 16, **m),
                         torch.empty(1, 8, 1, 16, **m),
                         torch.empty(1, 8, 1, 16, **m),
                         torch.empty(8, dtype=torch.bool, **m))
    st = torch.empty(2, 4, 4, **m)
    ops.wkv6_decode(*(torch.empty(2, 4, **m) for _ in range(4)),
                    torch.empty(2, 4, **m), st)
    ops.wkv6_batched(*(torch.empty(2, 40, 4, **m) for _ in range(4)),
                     torch.empty(2, 4, **m), st)
    ops.mandelbrot(torch.empty(8, 8, **m), torch.empty(8, 8, **m))
    ops.spin_image(torch.empty(16, 3, **m), torch.empty(2, 3, **m),
                   torch.empty(2, 3, **m))
    assert dispatch.launches() == {}
    for site in ("flash_attention", "flash_decode", "wkv6_decode",
                 "wkv6_batched", "mandelbrot", "spin_image"):
        assert dispatch.status(site)["path"] == "torch", site


def test_dryrun_cli_writes_records(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on two cells of full-size
    configs (one N/A by design): a record each and a summary, every
    state byte on meta (80 GB would not fit this process otherwise)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "olmo-1b,rwkv6-1.6b", "--shape", "decode_32k,long_500k",
         "--out", str(tmp_path)], env={"PYTHONPATH": str(SRC),
                                       "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert len(summary) == 4
    by = {(r["arch"], r["shape"]): r for r in summary}
    assert by[("olmo-1b", "long_500k")]["ok"] is None
    for key in [("olmo-1b", "decode_32k"), ("rwkv6-1.6b", "decode_32k"),
                ("rwkv6-1.6b", "long_500k")]:
        r = by[key]
        assert r["ok"] is True and r["flops"] > 0
        assert r["unfused_bytes"] >= r["min_bytes"] > 0
        assert set(r["roofline"]) == {"t_compute", "t_memory"}
        assert (tmp_path / f"{key[0]}__{key[1]}.json").exists()
    olmo = by[("olmo-1b", "decode_32k")]
    assert olmo["params"] == 1_176_764_416
    assert olmo["cache_bytes"] == 128 * 32768 * 16 * 2 * 16 * 128 * 2 \
        + 16 * 32768 * 4


KNOBS = ["--flash-threshold", "512", "--causal-skip", "--attn-bf16",
         "--parallelism", "dp", "--moe-group", "64", "--remat",
         "dots_saveable", "--microbatches", "2", "--tag", "knobs"]
KNOB_OVERRIDES = {"flash_threshold": 512, "flash_causal_skip": True,
                  "attn_scores_bf16": True, "parallelism": "dp",
                  "moe_group_size": 64, "remat_policy": "dots_saveable"}


def test_dryrun_flags_reach_the_cell(tmp_path, monkeypatch):
    """The reference's tuning flags (``--mesh`` aside): each reaches the
    config of every cell's step and its record, ``--microbatches`` the
    training step, and ``--tag`` names the files."""
    seen = []
    train_step, serve_step = dryrun.make_train_step, dryrun.make_serve_step

    def spy_train(cfg, **kw):
        seen.append((cfg, kw["num_microbatches"]))
        return train_step(cfg, **kw)

    def spy_serve(cfg):
        seen.append((cfg, None))
        return serve_step(cfg)

    monkeypatch.setattr(dryrun, "make_train_step", spy_train)
    monkeypatch.setattr(dryrun, "make_serve_step", spy_serve)
    with pytest.raises(SystemExit) as ex:
        dryrun.main(["--arch", "whisper-tiny", "--shape",
                     "train_4k,decode_32k", "--out", str(tmp_path)] + KNOBS)
    assert ex.value.code == 0
    assert [mb for _, mb in seen] == [2, None]
    for cfg, _ in seen:
        for key, val in KNOB_OVERRIDES.items():
            assert getattr(cfg, key) == val, key
    for shape in ("train_4k", "decode_32k"):
        rec = json.loads((tmp_path / f"whisper-tiny__{shape}__knobs.json")
                         .read_text())
        assert rec["ok"] is True and rec["overrides"] == KNOB_OVERRIDES
    assert rec.get("microbatches") is None
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary[0]["microbatches"] == 2


def test_dryrun_microbatches_lower_the_peak():
    """``--microbatches 2`` halves the rows a training step holds at once:
    a lower peak than the cell's own count (1 for whisper-tiny), the same
    state bytes; no override is recorded."""
    own = dryrun.run_cell("whisper-tiny", "train_4k")
    two = dryrun.run_cell("whisper-tiny", "train_4k", microbatches=2)
    assert own["microbatches"] == 1 and two["microbatches"] == 2
    assert two["peak_step_bytes"] < own["peak_step_bytes"]
    assert two["params_bytes"] == own["params_bytes"]
    assert own["overrides"] == two["overrides"] == {}
