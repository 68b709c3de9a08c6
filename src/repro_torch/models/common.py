"""Shared model substrate: parameter specs and init, norms, RoPE, dense.

Parameters are a tree of :class:`ParamTree` modules mirroring the
reference's nested-dict pytree: ``p["q"]["kernel"]`` and ``"bias" in p``
read the same in both packages, and a list of per-layer trees stands for
the reference's stacked ``layers`` axis.  The models read plain nested
dicts and lists of tensors the same way; :func:`tree_leaves` and
:func:`tree_map` walk either in the reference's flatten order (sorted
keys), which the optimizers and the training executor rely on.
:class:`ParamSpec` draws the
same distributions as ``repro.models.common.ParamSpec.materialize`` from a
seeded ``torch.Generator`` on the target device (the two frameworks give
different numbers from one seed; parity tests carry the reference's
weights across with ``models.convert.params_from_reference``).
``constrain`` has no counterpart: nothing is sharded on one card.
:func:`remat` is the counterpart of the reference's rematerialisation
policies (``scan_layers``' ``jax.checkpoint``), applied per layer.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

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
    submodules, lists become ``nn.ModuleList``s, tensors become
    parameters sharing the tensors' storage, frozen unless ``trainable``
    (then autograd tracks them: the training executor differentiates the
    loss with respect to them)."""

    def __init__(self, tree: dict, *, trainable: bool = False):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val, trainable=trainable))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(
                    ParamTree(v, trainable=trainable) for v in val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=trainable))

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


def tree_children(tree):
    """(key, child) pairs of a tree node in the reference's flatten order
    (dict keys sorted, lists in order); None for a leaf tensor."""
    if isinstance(tree, torch.Tensor):
        return None
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return list(enumerate(tree))
    if isinstance(tree, ParamTree):
        keys = list(tree._parameters) + list(tree._modules)
    elif isinstance(tree, dict):
        keys = list(tree)
    else:
        raise TypeError(f"not a parameter tree node: {type(tree).__name__}")
    return [(k, tree[k]) for k in sorted(keys)]


def tree_leaves(tree) -> list:
    """The tensors of a ParamTree or of nested dicts/lists, in flatten
    order."""
    kids = tree_children(tree)
    if kids is None:
        return [tree]
    return [leaf for _, c in kids for leaf in tree_leaves(c)]


def tree_named_leaves(tree, prefix: str = "") -> dict:
    """{key path: tensor} of a tree, paths joined with ``/`` (the
    checkpoint format's keys), in flatten order."""
    kids = tree_children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for k, c in kids:
        out.update(tree_named_leaves(c, f"{prefix}/{k}" if prefix
                                     else str(k)))
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``
    -> nested dicts (sorted keys) and lists of the results."""
    kids = tree_children(tree)
    if kids is None:
        return fn(tree, *rest)
    out = {k: tree_map(fn, c, *(r[k] for r in rest)) for k, c in kids}
    return [out[i] for i in range(len(out))] if isinstance(
        tree, (list, tuple, nn.ModuleList)) else out


def tree_unflatten(like, leaves):
    """``leaves`` (in flatten order) in the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def first_tensor(params) -> torch.Tensor:
    """Any tensor of ``params`` (its device and dtype are the tree's)."""
    return tree_leaves(params)[0]


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


# -------------------------------------------------------------------- loss
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy over logits (..., V) in float32;
    with ``mask``, the mean over the positions it weights."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


# ------------------------------------------------------------------- remat
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED_DOTS = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
#: the reference's policies (``jax.checkpoint_policies``) -> the matrix
#: products whose outputs the backward keeps (None: keep everything).
#: JAX's dots are ``dot_general``s; here a product without a batch
#: dimension is ``mm``/``addmm`` and one with is ``bmm``/``baddbmm``
REMAT_POLICIES = {
    "nothing_saveable": (),
    "dots_saveable": _DOTS + _BATCHED_DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS,
    "everything_saveable": None,
}


def remat(fn, policy: str):
    """``fn`` rematerialised under the reference's ``policy`` (a key of
    ``REMAT_POLICIES``; another raises ``KeyError``, as the reference's
    lookup does): under grad its activations are dropped after the
    forward and recomputed in the backward, except the products the
    policy keeps (``torch.utils.checkpoint``, non-reentrant; selective
    for the dots policies).  Without grad, and under
    ``everything_saveable``, ``fn`` runs as it is.  Values do not change:
    the recomputation repeats the forward's ops, so ``fn`` must write
    nothing in place that it reads."""
    keep = REMAT_POLICIES[policy]
    if keep is None:
        return fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if not keep:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              list(keep)))
    return wrapped
