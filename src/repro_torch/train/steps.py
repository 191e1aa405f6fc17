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

With ``dist`` (a :class:`~repro_torch.models.model.DistContext` whose mesh
is a ``DeviceMesh``) the step is one rank's part of the sharded step: the
parameters and optimizer state are DTensors
(:func:`repro_torch.models.sharding.shard_params`) and the batch is this
rank's shard (:func:`repro_torch.models.sharding.batch_specs`).

* Each rank's loss is its share of the JAX loss over the global batch:
  its tokens' summed cross-entropy and z-loss over the global token count
  (all-reduced over the batch axes ``dist.dp_axes``), plus the MoE
  auxiliary loss, which every rank holds whole, over the number of batch
  shards.  The metrics are the global values.
* The parameters are cast (``cast_params``) and then all-gathered, so the
  gathers travel in the compute dtype; every leaf is computed on whole,
  replicated, except the experts of an MoE layer, which stay sharded for
  the expert-parallel path (:mod:`repro_torch.models.moe`).
* The gradients of the gathered leaves are summed over the batch axes —
  not over ``"model"``, whose ranks hold the same tokens — and each rank
  keeps its block; an expert slice's gradient comes out of the
  expert-parallel path already summed over the FSDP axis.
* ``micro_steps`` splits this rank's shard.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as tdist

from ..models.convert import jax_ndims
from ..models.model import DistContext, Model
from ..models.sharding import axis_size, local_slice, spec_of
from ..optim.optimizers import Optimizer, clip_by_global_norm
from ..tree import leaves, leaves_with_path, map_tree, unflatten

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
    # without a mesh: one batch shard, and the sums below are the global ones
    sharded = dist is not None and dist.mesh is not None
    n_dp = axis_size(dist.mesh, tuple(dist.dp_axes)) if sharded else 1
    ntok = torch.clamp(_dp_sum(mask.sum(), dist), min=1)
    ce = nll.sum() / ntok
    zl = z_loss * ((lse * mask) ** 2).sum() / ntok
    share = ce + zl + aux_weight * aux / n_dp
    with torch.no_grad():
        ce_all, zl_all = _dp_sum(torch.stack([ce.detach(), zl.detach()]), dist)
    total = ce_all + zl_all + aux_weight * aux.detach()
    return share, {"loss": total, "ce": ce_all, "z_loss": zl_all,
                   "aux": aux.detach(), "ntok": ntok}


def _dp_sum(t: torch.Tensor, dist: Optional[DistContext], axes=None) -> torch.Tensor:
    """``t`` summed in place over the mesh's batch axes (or ``axes``); as it
    is without a mesh."""
    if dist is None or dist.mesh is None:
        return t
    for ax in dist.dp_axes if axes is None else axes:
        tdist.all_reduce(t, group=dist.mesh.get_group(ax))
    return t


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
    as a tree of ``params``' structure, and the metrics.  With ``dist``,
    ``params`` are DTensors and so are the gradients, each the global
    gradient's block of this rank."""
    if dist is not None and dist.mesh is not None:
        return _sharded_loss_and_grads(model, params, batch, dist, cast_params)
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    tree = unflatten(params, flat)
    if cast_params:
        tree = cast_for_compute(tree, model)
    loss, metrics = loss_fn(model, tree, batch, dist=dist)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return unflatten(params, grads), {k: v.detach() for k, v in metrics.items()}


EXPERTS = tuple(f"['ffn'][{w!r}]" for w in ("wi", "wg", "wo"))


def _expert_leaves(params, dist: DistContext) -> list[bool]:
    """Which leaves the expert-parallel path consumes as this rank's
    slices: the experts of an MoE layer, when the mesh has the expert
    axis."""
    if dist.ep_axis not in (dist.mesh.mesh_dim_names or ()):
        return [False] * len(leaves(params))
    return [path.endswith(EXPERTS) and leaf.dim() == 3
            for path, leaf in leaves_with_path(params)]


def _sharded_loss_and_grads(model: Model, params, batch, dist: DistContext,
                            cast_params: bool):
    from torch.distributed.tensor import DTensor

    mesh = dist.mesh
    experts = _expert_leaves(params, dist)
    with torch.no_grad():
        comp = leaves(cast_for_compute(params, model) if cast_params else params)
        work = [(c.to_local() if keep else c.full_tensor())
                if isinstance(c, DTensor) else c
                for c, keep in zip(comp, experts)]
    work = [w.detach().requires_grad_(True) for w in work]
    loss, metrics = loss_fn(model, unflatten(params, work), batch, dist=dist)
    grads = torch.autograd.grad(loss, work, allow_unused=True)
    fsdp = "data" if "data" in mesh.mesh_dim_names else dist.dp_axes[0]
    out = []
    with torch.no_grad():
        for p, w, g, keep in zip(leaves(params), work, grads, experts):
            g = torch.zeros_like(w, dtype=p.dtype) if g is None else g.to(p.dtype)
            if keep:        # summed over the FSDP axis by the gather's backward
                g = _dp_sum(g.contiguous(), dist, [a for a in dist.dp_axes if a != fsdp])
            else:
                g = _dp_sum(g.contiguous(), dist)
                if isinstance(p, DTensor):
                    g = local_slice(g, spec_of(p), mesh).contiguous()
            if isinstance(p, DTensor):
                g = DTensor.from_local(g, mesh, p.placements, run_check=False,
                                       shape=p.shape, stride=p.stride())
            out.append(g)
    return unflatten(params, out), {k: v.detach() for k, v in metrics.items()}


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
            if hasattr(gnorm, "full_tensor"):
                gnorm = gnorm.full_tensor()
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    return step


def make_eval_step(model: Model, *, dist: Optional[DistContext] = None):
    def step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(model, params, batch, dist=dist)
        return metrics
    return step
