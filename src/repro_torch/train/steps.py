"""Train and eval steps: the JAX package's ``train/steps.py`` on autograd.

``make_train_step`` builds ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``:

* next-token cross-entropy with label masking (-1), an f32 logsumexp,
  z-loss and the MoE auxiliary loss;
* optional microbatch gradient accumulation (``micro_steps`` chunks of
  the batch, their gradients summed in f32 and averaged; the last chunk's
  metrics);
* global-norm clipping, then the optimizer update.

``cast_params`` casts the f32 master weights to the model's compute dtype
before the forward pass, leaf for leaf as the JAX package does: it casts
``p.ndim >= 2`` in its own layout, where a scanned layer's leaves carry a
stacked ``reps`` axis, so here a leaf counts its rank in that layout
(:func:`repro_torch.models.convert.jax_ndims`).  A scanned layer's norm
scales and conv biases are then cast, a tail layer's are not.  The cast's
backward accumulates the gradient back into f32.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.convert import jax_ndims
from ..models.model import DistContext, Model
from ..optim.optimizers import Optimizer, clip_by_global_norm
from ..tree import leaves, map_tree, unflatten

__all__ = ["loss_fn", "loss_and_grads", "make_train_step", "make_eval_step",
           "cast_for_compute"]


def loss_fn(model: Model, params, batch, *, dist: Optional[DistContext] = None,
            z_loss: float = 1e-4, aux_weight: float = 1e-2):
    """``(total loss, metrics)`` of ``batch`` (``tokens``, ``labels`` with
    -1 masked, and the family's stub)."""
    logits, aux = model.forward(params, batch, dist=dist)
    labels = torch.as_tensor(batch["labels"]).to(logits.device)
    mask = labels >= 0
    lab = torch.where(mask, labels, 0).long()
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, lab[..., None])[..., 0]
    nll = (lse - ll) * mask
    ntok = torch.clamp(mask.sum(), min=1)
    ce = nll.sum() / ntok
    zl = z_loss * ((lse * mask) ** 2).sum() / ntok
    total = ce + zl + aux_weight * aux
    return total, {"loss": total, "ce": ce, "z_loss": zl, "aux": aux,
                   "ntok": ntok}


def cast_for_compute(params, model: Model):
    """``params`` with the leaves the JAX train step casts (f32, rank two or
    more in the JAX layout) in the model's compute dtype."""
    dt = model.dtype

    def cast(p, rank):
        return p.to(dt) if p.dtype == torch.float32 and rank >= 2 else p

    return map_tree(cast, params, jax_ndims(params, model.cfg))


def _split_batch(batch, micro_steps: int) -> list:
    def sp(x):
        x = torch.as_tensor(x)
        B = x.shape[0]
        if B % micro_steps:
            raise ValueError(f"batch {B} does not split into {micro_steps} micro steps")
        return x.reshape((micro_steps, B // micro_steps) + tuple(x.shape[1:]))

    parts = {k: sp(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(micro_steps)]


def loss_and_grads(model: Model, params, batch, *,
                   dist: Optional[DistContext] = None, cast_params: bool = True):
    """The gradient of :func:`loss_fn` with respect to every leaf of
    ``params`` (in the leaf's dtype; 0 for a leaf the loss does not read),
    as a tree of ``params``' structure, and the metrics."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    tree = unflatten(params, flat)
    if cast_params:
        tree = cast_for_compute(tree, model)
    loss, metrics = loss_fn(model, tree, batch, dist=dist)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return unflatten(params, grads), {k: v.detach() for k, v in metrics.items()}


def make_train_step(model: Model, optimizer: Optimizer, *,
                    dist: Optional[DistContext] = None,
                    micro_steps: int = 1, clip_norm: float = 1.0,
                    cast_params: bool = True):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; the parameters and state given are not changed."""

    def step(params, opt_state, batch):
        if micro_steps == 1:
            grads, metrics = loss_and_grads(model, params, batch, dist=dist,
                                            cast_params=cast_params)
        else:
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves(params)]
            for mb in _split_batch(batch, micro_steps):
                g, metrics = loss_and_grads(model, params, mb, dist=dist,
                                            cast_params=cast_params)
                acc = [a + gi for a, gi in zip(acc, leaves(g))]
            grads = unflatten(params, [a / micro_steps for a in acc])
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    return step


def make_eval_step(model: Model, *, dist: Optional[DistContext] = None):
    def step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(model, params, batch, dist=dist)
        return metrics
    return step
