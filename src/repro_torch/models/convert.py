"""Carry the reference's weights across: the parameter pytree of a
``repro`` model, as numpy arrays, into the port's parameter modules.

This is how every parity test gives both packages the same weights
(``torch.Generator`` cannot reproduce ``jax.random``), and the form
``repro.cluster.runners`` ships parameters in.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models.common import ParamSpec, ParamTree


def _to_tensor(a) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype (bfloat16 arrays, of
    ``ml_dtypes``, are carried bit for bit)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _convert(spec, tree, layer, path: str):
    if isinstance(spec, ParamSpec):
        a = np.asarray(tree)
        if layer is not None:
            a = a[layer]
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"{path}: reference shape {a.shape}, the "
                             f"port's {spec.shape}")
        t = _to_tensor(a)
        if t.dtype != spec.dtype:
            raise ValueError(f"{path}: reference dtype {t.dtype}, the "
                             f"port's {spec.dtype}")
        return t
    if isinstance(spec, list):                # the stacked layer axis
        return [_convert(s, tree, i, f"{path}[{i}]")
                for i, s in enumerate(spec)]
    missing = set(spec) ^ set(tree)
    if missing:
        raise ValueError(f"{path}: keys differ from the reference's: "
                         f"{sorted(missing)}")
    return {k: _convert(spec[k], tree[k], layer, f"{path}/{k}")
            for k in spec}


def params_from_reference(model, params_np: dict, *, device=None
                          ) -> ParamTree:
    """The reference's parameters (nested dicts of numpy arrays, the
    layer stacks with a leading ``layers`` axis) as ``model``'s parameter
    tree on ``device`` (None: the card), layers unstacked, dtypes kept."""
    tree = _convert(model.param_specs(), params_np, None, "params")
    return ParamTree(tree).to(resolve(device))
