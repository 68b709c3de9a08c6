"""Checkpoint/restart: the port of ``repro.checkpoint.store``, the
paper's comparison target (§3.1: rDLB beats checkpoint/restart when
C >= (λt²/8)(n+1)²/(q−1)²) and the fault-tolerance floor of the
train CLI.

The reference's format on disk: one ``.npy`` a leaf, named by its key
path (dict keys and list indices joined with ``/``, dicts in sorted-key
order), and a ``manifest.json`` holding the step and each leaf's key,
file, shape and logical dtype.  bfloat16 leaves, which numpy cannot
hold, are stored widened to float32 under the dtype name ``bfloat16``.
A checkpoint written by either package therefore loads in the other for
the same tree.  Leaves are copied to the host whole, so a restore may
place them on any ``device=`` (the one-card counterpart of the
reference's ``shardings=``).

Async mode overlaps writing with the next training step: ``maybe_save``
takes the host copy before it returns, so a later step cannot change
what a save writes, and only the previous save is waited for.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.models.common import (ParamTree, tree_children,
                                      tree_named_leaves)


def _rebuild(like, leaf_fn, prefix: str = "", wrap: bool = True):
    """``like``'s structure with ``leaf_fn(key, leaf)`` at each leaf; a
    ParamTree comes back as a ParamTree (built once, at its root)."""
    kids = tree_children(like)
    if kids is None:
        return leaf_fn(prefix, like)
    inner = wrap and not isinstance(like, ParamTree)
    out = {k: _rebuild(c, leaf_fn, f"{prefix}/{k}" if prefix else str(k),
                       inner)
           for k, c in kids}
    if isinstance(like, (list, tuple, nn.ModuleList)):
        return [out[i] for i in range(len(out))]
    return ParamTree(out) if wrap and isinstance(like, ParamTree) else out


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _host(tree) -> dict:
    """{key: host copy} of every leaf, taken now (a copy even of a CPU
    tensor, so later in-place writes cannot reach it)."""
    return {key: t.detach().to("cpu", copy=True)
            for key, t in tree_named_leaves(tree).items()}


def _write(directory, leaves: dict, step: int) -> None:
    d = Path(directory)
    tmp = d.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": []}
    for key, t in leaves.items():
        logical = _dtype_name(t)
        if t.dtype == torch.bfloat16:
            t = t.float()                 # numpy has no bfloat16: widened
        arr = t.numpy()
        fname = key.replace("/", "__") + ".npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(arr.shape),
             "dtype": logical})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if d.exists():
        shutil.rmtree(d)
    tmp.rename(d)                         # atomic-ish publish


def save_checkpoint(directory, tree, *, step: int = 0) -> None:
    """Write ``tree`` (tensors in dicts, lists and ParamTrees) to
    ``directory`` at ``step``."""
    _write(directory, _host(tree), step)


def load_checkpoint(directory, target, *, device=None):
    """Restore into ``target``'s structure and dtypes, each leaf on
    ``device`` (None: the target leaf's own device) -> (tree, step)."""
    d = Path(directory)
    manifest = json.loads((d / "manifest.json").read_text())
    by_key = {m["key"]: m for m in manifest["leaves"]}

    def leaf(key, like):
        arr = np.load(d / by_key[key]["file"])
        dev = like.device if device is None else device
        return torch.from_numpy(arr).to(device=dev, dtype=like.dtype)

    return _rebuild(target, leaf), manifest["step"]


class CheckpointManager:
    """Periodic (optionally async) checkpointing with retention."""

    def __init__(self, root, *, interval: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.root = Path(root)
        self.interval = interval
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self.save_seconds = 0.0

    def dir_for(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def latest(self) -> Optional[Path]:
        if not self.root.exists():
            return None
        # exclude in-progress async writes (step_*.tmp) and anything
        # without a published manifest
        steps = sorted(p for p in self.root.glob("step_*")
                       if p.suffix != ".tmp"
                       and (p / "manifest.json").exists())
        return steps[-1] if steps else None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def maybe_save(self, step: int, tree) -> bool:
        if step % self.interval:
            return False
        self.wait()                       # block on previous async save
        t0 = time.time()
        leaves = _host(tree)

        def _do():
            _write(self.dir_for(step), leaves, step)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()
        else:
            _do()
        self.save_seconds += time.time() - t0
        return True

    def restore_latest(self, target, *, device=None):
        self.wait()                       # a save may be in flight
        latest = self.latest()
        if latest is None:
            return None
        return load_checkpoint(latest, target, device=device)

    def _gc(self):
        steps = sorted(self.root.glob("step_*"))
        for old in steps[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)
