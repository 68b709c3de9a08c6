"""Model weights drawn from ``--seed`` on the run's device, in a few
large calls: one standard-normal buffer for each dtype, drawn by one
``torch.Generator``, then each leaf a view of it, shifted and scaled by
the first of the configuration's ``init`` rules that matches its path
(``fnmatch`` on ``a/b/0/c``).  A rule's ``std`` is a number or
``"fan_in"``: 1 / sqrt(the leaf's second-to-last dim, or its only one).
The same seed gives the same weights; both the program and the
reference read these tensors."""

from __future__ import annotations

import fnmatch
import math

import torch


def _leaves(specs, path=""):
    """(path, shape, dtype) of every leaf of a nested dict/list of specs
    (objects with ``shape`` and ``dtype``), dict keys sorted."""
    if isinstance(specs, dict):
        for k in sorted(specs):
            yield from _leaves(specs[k], f"{path}/{k}" if path else k)
    elif isinstance(specs, (list, tuple)):
        for i, s in enumerate(specs):
            yield from _leaves(s, f"{path}/{i}" if path else str(i))
    else:
        yield path, tuple(specs.shape), specs.dtype


def _rule(path: str, rules: list) -> dict:
    for r in rules:
        if fnmatch.fnmatchcase(path, r["match"]):
            return r
    raise KeyError(f"no init rule matches weight {path!r}")


def _std(rule: dict, shape: tuple) -> float:
    std = rule["std"]
    if std == "fan_in":
        fan = shape[-2] if len(shape) >= 2 else shape[-1]
        return 1.0 / math.sqrt(max(1, fan))
    return float(std)


def _tree(specs, flat: dict, path: str = ""):
    """``specs``' structure (empty groups kept) with ``flat[path]`` at
    each leaf."""
    def sub(k):
        return f"{path}/{k}" if path else str(k)
    if isinstance(specs, dict):
        return {k: _tree(specs[k], flat, sub(k)) for k in sorted(specs)}
    if isinstance(specs, (list, tuple)):
        return [_tree(s, flat, sub(i)) for i, s in enumerate(specs)]
    return flat[path]


def draw(specs, rules: list, seed: int, device) -> dict:
    """Nested dict (lists for layer stacks) of weight tensors shaped as
    ``specs``, drawn from ``seed`` on ``device``."""
    leaves = list(_leaves(specs))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    by_dtype: dict = {}
    for path, shape, dt in leaves:
        by_dtype.setdefault(dt, []).append((path, shape))
    flat = {}
    for dt in sorted(by_dtype, key=str):
        group = by_dtype[dt]
        total = sum(math.prod(s) for _, s in group)
        buf = torch.empty(total, dtype=dt, device=device)
        buf.normal_(generator=gen)
        off = 0
        for path, shape in group:
            n = math.prod(shape)
            leaf = buf[off:off + n].view(shape)
            off += n
            rule = _rule(path, rules)
            leaf.mul_(_std(rule, shape)).add_(float(rule.get("mean", 0.0)))
            flat[path] = leaf
    return _tree(specs, flat)
