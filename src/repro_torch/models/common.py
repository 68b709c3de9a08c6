"""Shared model substrate: parameter specs and init, norms, RoPE, dense.

Parameters are a tree of :class:`ParamTree` modules mirroring the
reference's nested-dict pytree: ``p["q"]["kernel"]`` and ``"bias" in p``
read the same in both packages, and a list of per-layer trees stands for
the reference's stacked ``layers`` axis.  :class:`ParamSpec` draws the
same distributions as ``repro.models.common.ParamSpec.materialize`` from a
seeded ``torch.Generator`` on the target device (the two frameworks give
different numbers from one seed; parity tests carry the reference's
weights across with ``models.convert.params_from_reference``).
``constrain`` has no counterpart: nothing is sharded on one card.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

Specs = Any   # nested dict / list structure with ParamSpec leaves


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    init: str = "normal"          # normal | zeros | ones | embed
    dtype: torch.dtype = torch.bfloat16
    init_scale: float = 1.0       # multiplies the fan-in normal std

    def std(self) -> float:
        if self.init == "embed":
            return 1.0
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        return self.init_scale / math.sqrt(max(1, fan_in))

    def materialize(self, generator: torch.Generator,
                    device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        x = torch.randn(self.shape, generator=generator,
                        dtype=torch.float32, device=device)
        return (x * self.std()).to(self.dtype)


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dict entries become
    submodules, lists become ``nn.ModuleList``s, tensors become frozen
    parameters (no gradients: this slice serves)."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(
                    ParamTree(v) for v in val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def _materialize(specs: Specs, generator, device):
    if isinstance(specs, ParamSpec):
        return specs.materialize(generator, device)
    if isinstance(specs, (list, tuple)):
        return [_materialize(s, generator, device) for s in specs]
    # sorted keys: the reference's tree_flatten order
    return {k: _materialize(specs[k], generator, device)
            for k in sorted(specs)}


def init_params(specs: Specs, *, seed: int, device: torch.device
                ) -> ParamTree:
    """Draw every leaf of ``specs`` from one ``torch.Generator`` seeded
    with ``seed`` on ``device``, leaves in sorted-key order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return ParamTree(_materialize(specs, gen, device))


def first_tensor(params: nn.Module) -> torch.Tensor:
    """Any parameter of ``params`` (its device and dtype are the tree's)."""
    return next(iter(params.parameters()))


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
             eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale, in float32, cast back."""
    w = None if scale is None else scale.float()
    return F.rms_norm(x.float(), (x.shape[-1],), w, eps).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics and affine, rounded once to x's
    dtype (PyTorch's kernel computes bfloat16 inputs in float32, so no
    cast is needed); with scale=bias=None this is OLMo's non-parametric
    LN."""
    return F.layer_norm(x, (x.shape[-1],), scale, bias, eps)


# -------------------------------------------------------------------- rope
@functools.lru_cache(maxsize=64)
def _rope_freqs(dim: int, theta: float, device: torch.device
                ) -> torch.Tensor:
    with torch.inference_mode(False):         # cached: a normal tensor
        exps = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=device) / dim
        return 1.0 / (theta ** exps)


def rope_freqs(dim: int, theta: float = 10000.0, *,
               device=None) -> torch.Tensor:
    """(dim/2,) float32 inverse frequencies, cached per (dim, theta,
    device); treat the result as read-only."""
    return _rope_freqs(int(dim), float(theta), torch.device(device or "cpu"))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, Dh) or (..., S, Dh); positions: (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (dh/2,)
    angles = positions[..., None].float() * freqs          # (..., S, dh/2)
    if x.dim() == angles.dim() + 1:                         # head axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- dense
def dense_specs(d_in: int, d_out: int, *, bias: bool = False,
                dtype=torch.bfloat16, init_scale: float = 1.0) -> dict:
    s = {"kernel": ParamSpec((d_in, d_out), dtype=dtype,
                             init_scale=init_scale)}
    if bias:
        s["bias"] = ParamSpec((d_out,), init="zeros", dtype=dtype)
    return s


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y
