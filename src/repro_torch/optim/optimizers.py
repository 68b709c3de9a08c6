"""Optimizers over parameter trees (optax-style interface): the port of
``repro.optim.optimizers``.

adamw      — float32 moments; the default for < 33B archs.
adafactor  — factored second moment for >= 2-D params (row/col RMS), no
             momentum: O(n+m) state instead of O(n*m).  Its statistics
             couple the layers of the reference's stacked ``layers``
             axis (a stack of 1-D scales is factored, the update is
             clipped by the RMS over the stack), so it stacks each layer
             list of the tree before it updates, and keeps its state in
             the reference's stacked shapes.

A tree is a ``ParamTree`` or nested dicts/lists of tensors; states and
updates are nested dicts/lists mirroring it (``models.common.tree_map``).
Both optimizers compute in float32 and return updates in the parameter's
dtype, so the apply step never upcasts the model; ``apply_updates`` adds
in float32 and rounds once.  Every scalar (bias corrections, the clip
scale) stays a tensor on the parameters' device: no host round trip.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models.common import (ParamTree, tree_children, tree_leaves,
                                       tree_map, tree_unflatten)


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]   # (grads, state, params)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def apply_updates(params, updates):
    """params + updates, added in float32 and rounded once to each
    parameter's dtype; a ParamTree comes back as a ParamTree."""
    new = tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                   params, updates)
    return ParamTree(new) if isinstance(params, ParamTree) else new


# ------------------------------------------------------------------- adamw
def adamw(lr: float = 1e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa
                                      device=p.device)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": _zero_step(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        t = step.float()
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)

        def upd(g, mu, nu, p):
            g = g.float()
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * g * g
            u = -(lr * (mu / c1) / (torch.sqrt(nu / c2) + eps)
                  + lr * weight_decay * p.float())
            return u.to(p.dtype), mu, nu

        trips = [upd(g, m, n, p) for g, m, n, p in zip(
            tree_leaves(grads), tree_leaves(state["mu"]),
            tree_leaves(state["nu"]), tree_leaves(params))]
        updates, mu, nu = (tree_unflatten(grads, [t3[i] for t3 in trips])
                           for i in range(3))
        return updates, {"mu": mu, "nu": nu, "step": step}

    return Optimizer(init, update)


def _zero_step(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


# --------------------------------------------------------------- adafactor
def adafactor(lr: float = 1e-4, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Factored RMS (Shazeer & Stern 2018), momentum-free."""

    def _factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1

    def init(params):
        def per_leaf(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        stacked = _stack_layers(params)
        return {"v": tree_unflatten(stacked, [per_leaf(p) for p in
                                              tree_leaves(stacked)]),
                "step": _zero_step(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        t = step.float()
        beta = 1.0 - t ** (-decay)          # increasing decay schedule

        def upd(g, v, p):
            g = g.float()
            g2 = g * g + eps
            if "vr" in v:
                vr = beta * v["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * v["vc"] + (1 - beta) * g2.mean(-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1)[..., None, None],
                                       min=eps))
                vnew = {"vr": vr, "vc": vc}
            else:
                denom = beta * v["v"] + (1 - beta) * g2
                vnew = {"v": denom}
            u = g * torch.rsqrt(denom + eps)
            # update clipping by RMS
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            u = -lr * u
            if weight_decay:
                u = u - lr * weight_decay * p.float()
            return u.to(p.dtype), vnew

        sg = _stack_layers(grads)
        pairs = [upd(g, v, p) for g, v, p in zip(
            tree_leaves(sg), _state_leaves(state["v"], sg),
            tree_leaves(_stack_layers(params)))]
        updates = _unstack_layers(tree_unflatten(sg, [u for u, _ in pairs]),
                                  grads)
        vnew = tree_unflatten(sg, [v for _, v in pairs])
        return updates, {"v": vnew, "step": step}

    return Optimizer(init, update)


def _is_list(node) -> bool:
    return isinstance(node, (list, tuple, torch.nn.ModuleList))


def _stack_layers(tree):
    """Each list of same-shaped layer trees -> one tree of tensors with a
    leading layer axis (the reference's stacked layout)."""
    kids = tree_children(tree)
    if kids is None:
        return tree
    if _is_list(tree):
        return tree_map(lambda *xs: torch.stack(xs), *tree)
    return {k: _stack_layers(c) for k, c in kids}


def _unstack_layers(stacked, like):
    """Inverse of :func:`_stack_layers`, in ``like``'s structure."""
    kids = tree_children(like)
    if kids is None:
        return stacked
    if _is_list(like):
        return [tree_map(lambda x: x[i], stacked) for i in range(len(like))]
    return {k: _unstack_layers(stacked[k], c) for k, c in kids}


def _state_leaves(tree, like) -> list:
    """The per-parameter state dicts of ``tree``, which has ``like``'s
    structure with a small dict ({"v"} or {"vr", "vc"}) at each leaf."""
    out = []
    tree_map(lambda _, v: out.append(v), like, tree)
    return out


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
