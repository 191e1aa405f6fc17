"""Optimizers of the port's training path: the JAX package's
``optim/optimizers.py`` as pairs of functions over the parameter tree.

An :class:`Optimizer` is ``init(params) -> state`` and ``update(grads,
state, params) -> (new_params, new_state)``, with the state a dict of
trees mirroring the parameters (``{"m": ..., "v": ..., "step": int32
scalar}``) and the arithmetic of the JAX package leaf for leaf: moments in
f32, the new parameter cast back to the parameter's dtype.  They are not
``torch.optim`` optimizers, so that each update can be held against the
JAX one.

The trees are the port's (:mod:`repro_torch.tree`): one leaf per layer
where the JAX package stacks the scanned layers.  Elementwise updates
(``adamw``, ``sgd``) do not see the difference; ``adafactor`` factors a
leaf of two or more dims and takes its update's RMS over the leaf, so a
scanned layer's vector (a ``(reps, D)`` leaf in JAX) is factored there and
not here, and a stacked leaf's RMS spans every repetition there and one
layer here.  With one repetition the two agree to rounding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from ..tree import leaves, map_tree

__all__ = ["Optimizer", "adamw", "adafactor", "sgd_momentum",
           "clip_by_global_norm", "cosine_schedule", "get_optimizer"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]   # (grads, state, params) -> (new_params, new_state)
    name: str = "opt"
    # host-side records of an optimizer that keeps any (tripre's factors)
    stats: dict = dataclasses.field(default_factory=dict)


def _step_zero(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)


def _unzip(out, n: int):
    """A tree of ``n``-tuples → ``n`` trees."""
    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        if isinstance(tree, list):
            return [pick(v, i) for v in tree]
        return tree[i]
    return tuple(pick(out, i) for i in range(n))


def _with_state(fn, grads, params, f):
    """``fn(g, p, f_leaf)`` over the leaves of ``grads`` and ``params`` and
    the state tree ``f``, whose leaves are dicts."""
    if isinstance(grads, dict):
        return {k: _with_state(fn, g, params[k], f[k]) for k, g in grads.items()}
    if isinstance(grads, list):
        return [_with_state(fn, g, p, fl) for g, p, fl in zip(grads, params, f)]
    return fn(grads, params, f)


def clip_by_global_norm(grads, max_norm: float):
    """``grads`` scaled so that their global norm is at most ``max_norm``,
    and that norm (f32, before scaling)."""
    gn = torch.sqrt(torch.stack([torch.sum(torch.square(g.float()))
                                 for g in leaves(grads)]).sum())
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return map_tree(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """``lr(step)``: linear warmup over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; f32, as the JAX schedule."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * (step + 1) / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return lr


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          schedule: Optional[Callable] = None) -> Optimizer:
    def init(params):
        zeros = map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return {"m": zeros, "v": map_tree(torch.clone, zeros),
                "step": _step_zero(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = schedule(step) if schedule else lr
        stepf = step.float()
        c1, c2 = 1 - b1 ** stepf, 1 - b2 ** stepf

        def upd(g, m, v, p):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            u = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p.float()
            return (p.float() - lr_t * u).to(p.dtype), m, v

        new_p, new_m, new_v = _unzip(map_tree(upd, grads, state["m"], state["v"],
                                              params), 3)
        return new_p, {"m": new_m, "v": new_v, "step": step}

    return Optimizer(init, update, "adamw")


def sgd_momentum(lr=1e-2, momentum=0.9) -> Optimizer:
    def init(params):
        return {"m": map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
                "step": _step_zero(params)}

    def update(grads, state, params):
        def upd(g, m, p):
            m = momentum * m + g.float()
            return (p.float() - lr * m).to(p.dtype), m

        new_p, new_m = _unzip(map_tree(upd, grads, state["m"], params), 2)
        return new_p, {"m": new_m, "step": state["step"] + 1}

    return Optimizer(init, update, "sgd")


def adafactor(lr=1e-2, decay=0.8, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0, schedule: Optional[Callable] = None) -> Optimizer:
    """Factored second moment for leaves of two or more dims (over the last
    two), a full one for vectors; no first moment."""

    def _factored(p):
        return p.dim() >= 2

    def init(params):
        def one(p):
            if _factored(p):
                return {"vr": p.new_zeros(p.shape[:-1], dtype=torch.float32),
                        "vc": p.new_zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"f": map_tree(one, params), "step": _step_zero(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        beta = 1.0 - step.float() ** -decay
        lr_t = schedule(step) if schedule else lr

        def upd(g, p, f):
            g = g.float()
            g2 = g * g + eps
            if _factored(p):
                vr = beta * f["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * f["vc"] + (1 - beta) * g2.mean(-2)
                denom = torch.clamp(vr.mean(-1, keepdim=True), min=eps)
                u = g / torch.sqrt(torch.clamp(
                    vr[..., None] * vc[..., None, :] / denom[..., None], min=eps))
                new_f = {"vr": vr, "vc": vc}
            else:
                v = beta * f["v"] + (1 - beta) * g2
                u = g / torch.sqrt(torch.clamp(v, min=eps))
                new_f = {"v": v}
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (p.float() - lr_t * u).to(p.dtype), new_f

        new_p, new_f = _unzip(_with_state(upd, grads, params, state["f"]), 2)
        return new_p, {"f": new_f, "step": step}

    return Optimizer(init, update, "adafactor")


def get_optimizer(name: str, lr: float = 3e-4, total_steps: int = 10_000,
                  **kw) -> Optimizer:
    sched = cosine_schedule(lr, min(100, total_steps // 10), total_steps)
    if name == "adamw":
        return adamw(lr, schedule=sched, **kw)
    if name == "adafactor":
        return adafactor(lr, schedule=sched, **kw)
    if name == "sgd":
        return sgd_momentum(lr, **kw)
    if name == "tripre":
        from .tripre import tripre
        return tripre(lr, schedule=sched, **kw)
    raise ValueError(name)
