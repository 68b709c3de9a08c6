"""The port's checkpoint/restart (``repro_torch.checkpoint``) on the CPU:
twins of the reference's tests (``tests/test_substrate.py``, its
checkpoint section, and the train CLI's in ``tests/test_launchers.py``),
checkpoints that cross between the two packages in both directions, and
the ordering of async saves.

Values must come back exactly (bfloat16 leaves are stored widened to
float32, which holds every bfloat16 value), and a run restarted from a
checkpoint must give the losses and parameters of one that never
stopped, bit for bit.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint import store
from repro_torch.data import batch_for_step
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.models.common import ParamTree, tree_leaves
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import RDLBTrainExecutor


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small shapes: one intra-op thread (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1.5, -2.25, 3.0, 2.0 ** -9],
                                    dtype=torch.bfloat16),
                  "d": torch.tensor(7, dtype=torch.int32)},
            "l": [torch.ones(2), torch.zeros(1, dtype=torch.int64)]}


def same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ------------------------------------------- twins of tests/test_substrate
def test_checkpoint_roundtrip(tmp_path):
    t = tree()
    save_checkpoint(tmp_path / "ck", t, step=42)
    restored, step = load_checkpoint(tmp_path / "ck", t)
    assert step == 42 and same(restored, t)
    assert isinstance(restored["l"], list)


def test_checkpoint_manager_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, interval=1, keep=2, async_save=False)
    t = {"x": torch.zeros(3)}
    for s in range(1, 5):
        mgr.maybe_save(s, t)
    mgr.wait()
    dirs = sorted(p.name for p in tmp_path.glob("step_*"))
    assert dirs == ["step_00000003", "step_00000004"]
    restored = mgr.restore_latest(t)
    assert restored is not None and restored[1] == 4


def test_checkpoint_async_overlap(tmp_path):
    mgr = CheckpointManager(tmp_path, interval=1, keep=1, async_save=True)
    t = {"x": torch.arange(10)}
    assert mgr.maybe_save(1, t)
    mgr.wait()
    assert mgr.latest() is not None
    assert mgr.save_seconds > 0


def test_restart_training_equivalence(tmp_path):
    """checkpoint -> restart reproduces the same parameters as an
    uninterrupted run (the checkpoint/restart baseline of §3.1)."""
    cfg = ModelConfig(family="dense", n_layers=1, d_model=32, n_heads=2,
                      n_kv_heads=2, d_ff=64, vocab_size=128)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    ex = RDLBTrainExecutor(model, n_workers=2, n_tasks=4,
                           exact_accumulation=True)
    opt = ex.opt.init(params)

    p, o = params, opt
    for s in range(4):
        r = ex.train_step(p, o, batch_for_step(cfg, s, 8, 16))
        p, o = r.params, r.opt_state

    p2, o2 = params, opt
    for s in range(2):
        r = ex.train_step(p2, o2, batch_for_step(cfg, s, 8, 16))
        p2, o2 = r.params, r.opt_state
    save_checkpoint(tmp_path / "ck", {"p": p2, "o": o2}, step=2)
    (state, step) = load_checkpoint(tmp_path / "ck", {"p": p2, "o": o2})
    p2, o2 = state["p"], state["o"]
    assert isinstance(p2, ParamTree) and step == 2
    for s in range(step, 4):
        r = ex.train_step(p2, o2, batch_for_step(cfg, s, 8, 16))
        p2, o2 = r.params, r.opt_state
    assert same(p, p2)


# ---------------------------------------------- the two packages' formats
def test_port_checkpoint_loads_in_the_reference(tmp_path):
    t = tree()
    save_checkpoint(tmp_path / "ck", t, step=5)
    target = {"a": jnp.zeros((2, 3), jnp.float32),
              "b": {"c": jnp.zeros((4,), jnp.bfloat16),
                    "d": jnp.int32(0)},
              "l": [jnp.zeros((2,)), jnp.zeros((1,), jnp.int32)]}
    got, step = jload(tmp_path / "ck", target)
    assert step == 5
    assert jnp.asarray(got["b"]["c"]).dtype == jnp.bfloat16
    for x, y in zip(jax.tree_util.tree_leaves(got), tree_leaves(t)):
        assert np.array_equal(np.asarray(x, np.float64),
                              y.double().numpy())


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    jt = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
          "b": {"c": jnp.asarray([1.5, -2.25, 3.0, 2.0 ** -9],
                                 jnp.bfloat16),
                "d": jnp.int32(7)},
          "l": [jnp.ones((2,)), jnp.zeros((1,), jnp.int32)]}
    jsave(tmp_path / "ck", jt, step=9)
    target = tree()
    target["l"][1] = torch.zeros(1, dtype=torch.int32)
    got, step = load_checkpoint(tmp_path / "ck", target, device="cpu")
    assert step == 9
    want = tree()
    want["l"][1] = torch.zeros(1, dtype=torch.int32)
    assert same(got, want)


def test_manifest_names_the_logical_dtype(tmp_path):
    import json
    save_checkpoint(tmp_path / "ck", tree(), step=1)
    man = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    by = {m["key"]: m for m in man["leaves"]}
    assert set(by) == {"a", "b/c", "b/d", "l/0", "l/1"}
    assert by["b/c"]["dtype"] == "bfloat16" and by["b/d"]["shape"] == []
    assert np.load(tmp_path / "ck" / by["b/c"]["file"]).dtype == np.float32


# ------------------------------------------------------------ async order
def test_host_copy_is_taken_before_maybe_save_returns(tmp_path, monkeypatch):
    """A step that writes the tree in place after ``maybe_save`` returns
    cannot reach the saved checkpoint, even while the write is held."""
    gate = threading.Event()
    real = store._write

    def held(*a):
        gate.wait(timeout=30)
        real(*a)

    monkeypatch.setattr(store, "_write", held)
    mgr = CheckpointManager(tmp_path, interval=1, async_save=True)
    t = {"x": torch.ones(4)}
    mgr.maybe_save(1, t)
    t["x"].add_(5.0)
    gate.set()
    mgr.wait()
    got, _ = load_checkpoint(mgr.latest(), t)
    assert torch.equal(got["x"], torch.ones(4))


def test_restore_latest_waits_for_a_save_in_flight(tmp_path, monkeypatch):
    """While an async save of step 2 is held, ``latest()`` skips it (only
    ``.tmp`` exists) and ``restore_latest`` waits and returns step 2."""
    gate = threading.Event()
    entered = threading.Event()
    real = store._write

    def held(directory, leaves, step):
        if step == 2:
            tmp = directory.with_suffix(".tmp")
            tmp.mkdir(parents=True)
            entered.set()
            gate.wait(timeout=30)
        real(directory, leaves, step)

    monkeypatch.setattr(store, "_write", held)
    mgr = CheckpointManager(tmp_path, interval=1, async_save=True)
    t = {"x": torch.zeros(2)}
    mgr.maybe_save(1, t)
    mgr.wait()
    mgr.maybe_save(2, {"x": torch.full((2,), 2.0)})
    assert entered.wait(timeout=30)
    (tmp_path / "step_00000003").mkdir()         # unpublished: no manifest
    assert mgr.latest().name == "step_00000001"
    threading.Timer(0.2, gate.set).start()
    got, step = mgr.restore_latest(t)
    assert step == 2 and torch.equal(got["x"], torch.full((2,), 2.0))


# --------------------------------------- twins of tests/test_launchers.py
CLI = ["--arch", "olmo-1b", "--smoke", "--global-batch", "8",
       "--seq-len", "32", "--device", "cpu"]


def test_train_cli_with_failures(tmp_path):
    losses = ttrain.main(CLI + [
        "--steps", "6", "--n-workers", "4", "--n-tasks", "8",
        "--fail", "2:1", "--ckpt-dir", str(tmp_path / "ck"),
        "--ckpt-interval", "2"])
    assert len(losses) == 6
    assert losses[-1] < losses[0]
    assert sorted(p.name for p in (tmp_path / "ck").glob("step_*")) == [
        "step_00000002", "step_00000004", "step_00000006"]


@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-1.6b"])
def test_train_cli_nordlb_hang_restarts(tmp_path, capsys, arch):
    """Without rDLB a failure hangs the step; the CLI restarts from the
    last checkpoint and finishes with the losses of a failure-free run at
    every step.  Two workers and two tasks: two gradients sum to the same
    bits in either arrival order, so threads cannot change them."""
    def run(steps, *extra):
        return ttrain.main(["--arch", arch, "--smoke", "--global-batch",
                            "4", "--seq-len", "32", "--device", "cpu",
                            "--steps", str(steps), "--n-workers", "2",
                            "--n-tasks", "2", "--no-rdlb", *extra])

    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-interval", "1"]
    losses = run(5, "--fail", "3:1", *ck)
    out = capsys.readouterr().out
    assert "step 3: HUNG" in out and "restored checkpoint at step 3" in out
    calm = run(6)
    assert losses == calm[:5]
    # a new run on the same directory starts from its latest checkpoint
    more = run(6, *ck)
    assert "restored checkpoint at step 5" in capsys.readouterr().out
    assert more == calm[5:]
