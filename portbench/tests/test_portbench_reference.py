"""Each reference family against the port's plain path (CPU) at its
smoke config in float32, on the same weights drawn by the benchmark:
the port's full forward and the reference give the same logits; a
batch of ragged sequences gives what each gives alone; the float8
control departs from float32."""

import numpy as np
import pytest
import torch

from portbench import harness, judge, weights
from repro_torch.models.common import ParamTree
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model, forward_logits

SMOKES = ("olmo-smoke", "rwkv6-smoke")


def setup(name, seed=5):
    cfg_json = harness.load_json("configs", name)
    model_json = dict(cfg_json["model"], dtype="float32")
    cfg = ModelConfig.from_reference(model_json)
    model = build_model(cfg)
    w = weights.draw(model.param_specs(), cfg_json["init"], seed, "cpu")
    ref = harness.load_module("reference", cfg_json["family"])
    return model, w, ref, {**model_json, **cfg_json.get("port_constants",
                                                        {})}


@pytest.mark.parametrize("name", SMOKES)
def test_reference_equals_port_plain_path(name):
    model, w, ref, model_dict = setup(name)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 37), generator=g)
    with torch.inference_mode():
        want = forward_logits(model, ParamTree(w), {"tokens": tokens})
    seqs = [t.numpy() for t in tokens]
    got = ref.logits(w, model_dict, seqs, [np.arange(37)] * 2,
                     device="cpu")
    scale = float(want.abs().max())
    for r in range(2):
        torch.testing.assert_close(got[r], want[r].float(), rtol=0,
                                   atol=2e-5 * scale)


@pytest.mark.parametrize("name", SMOKES)
def test_ragged_batch_equals_each_alone(name):
    _, w, ref, model_dict = setup(name, seed=9)
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 512, size=n) for n in (5, 40, 17)]
    pos = [np.arange(n) for n in (5, 40, 17)]
    together = ref.logits(w, model_dict, seqs, pos, device="cpu")
    for s, p, t in zip(seqs, pos, together):
        alone = ref.logits(w, model_dict, [s], [p], device="cpu")[0]
        torch.testing.assert_close(t, alone, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", SMOKES)
def test_fp8_control_departs(name):
    _, w, ref, model_dict = setup(name, seed=2)
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 512, size=60)]
    pos = [np.arange(60)]
    exact = ref.logits(w, model_dict, seqs, pos, device="cpu")
    low = ref.logits(w, model_dict, seqs, pos, precision="fp8",
                     device="cpu")
    assert not torch.allclose(exact[0], low[0], atol=1e-3)
    firsts = [lg.argmax(-1).numpy() for lg in low]
    assert judge.gaps(exact, firsts).max() > 0
