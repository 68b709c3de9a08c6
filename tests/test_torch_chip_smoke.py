"""``chip_smoke.py``'s pure helpers, on the CPU.

The script holds flash_decode against its plain version at the slot
masks it expects each served request's last decode step to hand the
kernel (``served_valid``).  Here those masks are checked against the
ones the smoke configs' models really build: a request through
``FusedGenerator`` with the same number of new tokens, the masks caught
at the decode op.

Phase 9 (the serving executor's four decode modes, its legacy surface)
is rehearsed at smoke size in float32: its requests, its launch
expectations, and its drive itself, the serving wrappers counting a
launch before their plain versions run as they count one on the card.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs import get_smoke
from repro_torch.kernels import dispatch, ops
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.runtime import serve_executor
from repro_torch.runtime.serve_executor import FusedGenerator

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def expected_masks(cfg, p: int) -> list:
    """The masks phase 6 (and phase 2, for the dense family) times."""
    n = p + chip_smoke.SERVE_NEW
    served = chip_smoke.served_valid
    if cfg.family == "vlm":
        patch = cfg.n_patch_tokens
        return [served(n + patch, p, off=patch)]
    if cfg.family == "hybrid":
        meta, win = cfg.n_meta_tokens, cfg.sliding_window
        return [served(n + meta, p, off=meta),
                served(min(win, n + meta), p, off=meta, window=win)]
    return [served(n, p)]


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-tiny",
                                  "hymba-1.5b", "olmo-1b"])
@pytest.mark.parametrize("p", [5, 30])
def test_served_masks_are_the_models(arch, p, monkeypatch):
    cfg = get_smoke(arch).replace(dtype="float32")
    if cfg.family == "hybrid":
        # a window the 30-token request wraps (meta tokens are not fed)
        cfg = cfg.replace(sliding_window=24)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    seen = {}
    decode = attn.ops.flash_decode_gqa

    def spy(q, k, v, valid, **kw):
        seen[valid.numel()] = valid.clone()   # the last step's, per L
        return decode(q, k, v, valid, **kw)

    monkeypatch.setattr(attn.ops, "flash_decode_gqa", spy)
    FusedGenerator(model)(params, np.ones((1, p), np.int32),
                          chip_smoke.SERVE_NEW)
    for want in expected_masks(cfg, p):
        assert torch.equal(seen[want.numel()], want)


# ------------------------------------------------------------ phase 9
def test_exec_requests_open_with_an_equal_length_pair():
    reqs = chip_smoke.exec_requests(100)
    assert [len(r.prompt) for r in reqs] == [37, 37, 64, 37, 37]
    assert all(r.max_new_tokens == chip_smoke.SERVE_NEW for r in reqs)
    assert all(np.array_equal(a.prompt, b.prompt) for a, b in
               zip(reqs, chip_smoke.exec_requests(100)))
    assert len(chip_smoke.exec_requests(100, 4)) == 4


def test_exec_launch_problems():
    """The mode table's expectations: n_layers launches of the prefill
    site a prefill call and of the decode site a decode step (a fused
    group's SERVE_NEW - 1 steps, graphed or not), no other site, no
    prefill in the per-token loop modes."""
    sites, L = ("flash_attention", "flash_decode"), 3
    fused = {"prefill": 2, "decode_step": 30}
    loop = {"prefill": 0, "decode_step": 100}
    check = chip_smoke.exec_launch_problems
    assert check(sites, L, True, fused,
                 {"flash_attention": 6, "flash_decode": 90}) == []
    assert check(sites, L, False, loop,
                 {"flash_decode": 300, "flash_attention": 0}) == []
    assert check(sites, L, True, fused,
                 {"flash_attention": 6, "flash_decode": 91})
    assert check(sites, L, False, loop,
                 {"flash_decode": 300, "flash_attention": 3})
    assert check(sites, L, False, fused,
                 {"flash_attention": 6, "flash_decode": 90})
    assert check(sites, L, True, fused, {"flash_attention": 6,
                                         "flash_decode": 90, "other": 1})
    assert check(sites, L, False, {"prefill": 0, "decode_step": 0}, {})
    # graphed groups call decode_step twice (step 1 and the capture) and
    # replay the rest: the launches still count every step
    graphed = {"prefill": 2, "decode_step": 4}
    assert check(sites, L, True, graphed,
                 {"flash_attention": 6, "flash_decode": 90},
                 graphed=True) == []
    assert check(sites, L, True, graphed,
                 {"flash_attention": 6, "flash_decode": 12}, graphed=True)
    assert check(sites, L, True, fused,
                 {"flash_attention": 6, "flash_decode": 90}, graphed=True)
    assert check(sites, L, True, graphed,
                 {"flash_attention": 6, "flash_decode": 90})


@pytest.mark.parametrize("captures,calls,ok", [
    (None, 0, True), (None, 2, True), (None, 4, True), (None, 3, False),
    (None, 6, False), (0, 0, True), (1, 2, True), (2, 4, True),
    (1, 4, False), (0, 2, False)])
def test_exec_launch_problems_with_kept_graphs(captures, calls, ok):
    """A group that replays a graph its lane kept calls ``decode_step``
    never, one that captures twice: the calls are two a capture where
    the run counted them, else an even number, two a group at most; the
    launches still count every step."""
    sites, L = ("flash_attention", "flash_decode"), 3
    launches = {"flash_attention": 6, "flash_decode": 90}
    got = chip_smoke.exec_launch_problems(
        sites, L, True, {"prefill": 2, "decode_step": calls}, launches,
        graphed=True, captures=captures)
    assert (got == []) is ok


@pytest.mark.parametrize("segments,prefills,groups,wkv,ok", [
    ((1, 2), 2, (37, 64, 1000), 6, True),    # a capture, two hits
    ((0, 3), 0, (37, 64, 1000), 6, True),    # every segment a hit
    ((2, 3), 4, (1100, 2040, 300), 10, True),  # groups of two segments
    ((1, 2), 1, (37, 64, 1000), 6, False),   # a capture calls prefill twice
    ((1, 2), 3, (37, 64, 1000), 6, False),   # a hit calls no prefill
    ((1, 2), 2, (37, 64, 1000), 4, False),   # launches counted a group
    ((1, 2), 2, (37, 64, 1000), 8, False),   # a capture's own launches
    ((0, 1), 0, (37, 64, 1000), 2, False),   # segments lost
    ((1, 3), 2, (37, 64, 1000), 8, False),   # a group prefilled twice
    ((1, 2), 2, (37, 64, 2040), 6, False),   # a long prompt in one segment
    ((0, 0), 0, (), 0, False)])              # nothing prefilled
def test_exec_launch_problems_with_segments(segments, prefills, groups, wkv,
                                            ok):
    """Groups that prefill in segments replayed from kept graphs launch
    the prefill site once a layer a segment, eager or replayed, call
    ``prefill`` twice a capture and never for a hit, run the segments
    ``prefill_segments`` plans for the prompt lengths of the groups
    served, and call ``decode_step`` SERVE_NEW - 1 times a group (rwkv6
    decodes eagerly): a step more, or a group's steps more, is wrong."""
    sites, L = ("wkv6_batched", "wkv6_decode"), 2
    steps = len(groups) * (chip_smoke.SERVE_NEW - 1)
    launches = {"wkv6_batched": wkv, "wkv6_decode": L * steps}
    calls = {"prefill": prefills, "decode_step": steps,
             "groups": list(groups)}
    got = chip_smoke.exec_launch_problems(sites, L, True, calls, launches,
                                          segments=segments)
    assert (got == []) is ok, got
    for more in (1, chip_smoke.SERVE_NEW - 1):
        odd = dict(calls, decode_step=steps + more)
        assert chip_smoke.exec_launch_problems(
            sites, L, True, odd,
            dict(launches, wkv6_decode=L * (steps + more)),
            segments=segments)


def test_model_calls_count_the_groups_an_executor_serves(monkeypatch):
    """``ModelCalls.watching`` adds the prompt length of each group the
    executor hands its fused generator, and gives the executor its own
    generator back after the block; an executor without one counts no
    group."""
    cfg = get_smoke("rwkv6-1.6b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    calls = chip_smoke.ModelCalls(model)
    monkeypatch.setattr(chip_smoke, "EXEC_PROMPTS", (5, 5, 9, 5, 5))
    monkeypatch.setattr(chip_smoke, "SERVE_NEW", 3)
    for batch, want in ((True, [5, 9]), (False, [5, 5, 9, 5, 5])):
        ex = serve_executor.RDLBServeExecutor(
            model, params, spec=chip_smoke.exec_spec(1),
            batch_decode=batch, fused_decode=True)
        gen = ex._fused
        _, _, _, n = chip_smoke.exec_serve(
            ex, chip_smoke.exec_requests(cfg.vocab_size), calls)
        assert sorted(n["groups"]) == sorted(want)
        assert n["prefill"] == len(want) and ex._fused is gen
    ex = serve_executor.RDLBServeExecutor(
        model, params, spec=chip_smoke.exec_spec(1), fused_decode=False)
    _, _, _, n = chip_smoke.exec_serve(
        ex, chip_smoke.exec_requests(cfg.vocab_size), calls)
    assert n["groups"] == [] and n["decode_step"] > 0


@pytest.mark.parametrize("T,n", [(96, 64), (96, 70), (64, 1)])
def test_wkv6_padding_gap_of_the_plain_version(T, n):
    """Phase 2's padded-tail check on the plain version, which sums each
    chunk's log decays in order, so padding past any real count leaves
    the state bit for bit; the real steps' y too where the padding fills
    whole chunks, and within 1e-6 where the matrix products of a chunk
    of one real step and of a chunk of 32 may sum in another order.  A
    tail that is not padded (w kept) is told apart."""
    from repro_torch.kernels import rwkv6_scan as kw
    gen = torch.Generator().manual_seed(n)
    ins = chip_smoke.wkv_inputs(torch.device("cpu"), gen, 3, T, 16,
                                torch.float32)
    e_state, e_y, exact = chip_smoke.wkv6_padding_gap(kw.wkv6_batched,
                                                      ins, n)
    assert e_state == 0.0 and e_y <= 1e-6
    assert exact or n % kw.CHUNK

    def unpadded_w(r, k, v, w, u, s):
        return kw.wkv6_batched(r, k, v, ins[3][:, :w.shape[1]], u, s)
    e_state, _, exact = chip_smoke.wkv6_padding_gap(unpadded_w, ins, n)
    assert not exact and e_state > 1e-3


@pytest.fixture
def counted_launches(monkeypatch):
    """The serving wrappers count a launch, then run their plain
    versions (the CPU's path)."""
    for site, name in (("flash_attention", "flash_attention_gqa"),
                       ("flash_decode", "flash_decode_gqa"),
                       ("wkv6_batched", "wkv6_batched"),
                       ("wkv6_decode", "wkv6_decode")):
        def counting(*args, _fn=getattr(ops, name), _site=site, **kwargs):
            dispatch.count_launch(_site)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(ops, name, counting)


@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-1.6b"])
def test_exec_phase_at_smoke_size(arch, counted_launches, monkeypatch):
    """Phase 9's drive on a float32 smoke config, with prompts of 5 and 9
    tokens (in the script's order) and 4 new ones: each mode's fail-stop and failure-free runs
    (launches as the mode table expects, tokens equal), the same tokens
    across the four modes, groups of two only where batch_decode is on;
    the legacy cases on the dense config; the float32 cross-mode check
    on the smoke config in place of the full-width one."""
    monkeypatch.setattr(chip_smoke, "EXEC_PROMPTS", (5, 5, 9, 5, 5))
    monkeypatch.setattr(chip_smoke, "SERVE_NEW", 4)
    cfg = get_smoke(arch).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    calls = chip_smoke.ModelCalls(model)
    sizes = []
    call = FusedGenerator.__call__

    def spy(self, params, prompts, max_new):
        sizes.append(prompts.shape[0])
        return call(self, params, prompts, max_new)

    monkeypatch.setattr(FusedGenerator, "__call__", spy)
    tokens = {}
    for mode in chip_smoke.EXEC_MODES:
        sizes.clear()
        res = chip_smoke.exec_mode(model, params, calls, mode,
                                   chip_smoke.EXEC_SITES[arch])
        tokens[mode] = res["tokens"]
        assert chip_smoke.same_tokens(res["tokens"],
                                      tokens[(True, True)]) == []
        if mode[1]:
            assert (max(sizes) == 2) == mode[0], (mode, sizes)
    if cfg.family == "dense":
        chip_smoke.exec_legacy(model, params, calls, tokens)
    monkeypatch.setattr(configs, "get_config", get_smoke)
    launches = chip_smoke.exec_cross_mode(torch.device("cpu"), arch)
    prefill_site = chip_smoke.EXEC_SITES[arch][0]
    assert [n.get(prefill_site, 0) > 0 for n in launches.values()] \
        == [fused for _, fused in chip_smoke.EXEC_MODES]


def test_plain_versions_drop_the_kept_graphs(monkeypatch):
    """A lane's kept decode-step graph replays the kernels it captured,
    so the plain-version run starts with no lane kept, and the lanes it
    leaves (graphs of the plain versions) are dropped after it."""
    lanes = {torch.device("cpu"): ["a lane keeping kernel graphs"]}
    monkeypatch.setattr(serve_executor, "_free_lanes", lanes)
    with chip_smoke.plain_versions():
        assert lanes == {}
        lanes[torch.device("cpu")] = ["a lane keeping plain graphs"]
    assert lanes == {}
