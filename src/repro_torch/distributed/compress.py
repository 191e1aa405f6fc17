"""Gradient compression: int8 quantize -> all_reduce -> dequantize, with an
error-feedback residual (1-bit-Adam-style EF, so the compression error does
not accumulate as bias): the JAX package's ``distributed/compress.py`` on
``torch.distributed``.

A process group (or a mesh and the name of one of its dimensions) takes the
place of the JAX axis name: the ``pmax`` of the scales is an
``all_reduce(MAX)``, the ``psum`` of the rescaled int32 values an
``all_reduce(SUM)``, and the result is divided by the group's size.  A
library function, as in the JAX package: no Trainer calls it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from ..tree import leaves, map_tree, unflatten

__all__ = ["CompressionState", "compressed_allreduce", "make_compressed_grad_fn"]


@dataclasses.dataclass
class CompressionState:
    residual: Any           # error-feedback residual, like grads (f32)

    @staticmethod
    def init(grads_like):
        return CompressionState(map_tree(
            lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
            grads_like))


def _group(group, mesh=None):
    """``group``, or the process group of ``mesh``'s dimension named
    ``group``."""
    return mesh.get_group(group) if mesh is not None else group


def _quant(g: torch.Tensor):
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_allreduce(g: torch.Tensor, residual: torch.Tensor, group=None, *,
                         mesh=None):
    """One tensor: the EF-int8 mean over ``group`` (a process group, None
    for the default one, or with ``mesh`` the name of its dimension) →
    ``(mean, new residual)``.  Every rank of the group calls it."""
    group = _group(group, mesh)
    g = g.float() + residual
    q, scale = _quant(g)
    deq = q.float() * scale
    new_residual = g - deq
    # each rank's int8 values at its own scale: rescaled to the largest
    # scale, summed in int32, the error left to the EF residual
    smax = scale.clone()
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    q_rescaled = torch.round(deq / smax).to(torch.int32)
    dist.all_reduce(q_rescaled, group=group)
    total = q_rescaled.float() * smax
    n = float(dist.get_world_size(group))
    return total / n, new_residual


def make_compressed_grad_fn(mesh, axis: str = "pod"):
    """Tree-level wrapper: all-reduce grads over the mesh dimension
    ``axis`` with EF-int8, leaf by leaf: ``reduce_tree(grads, state) ->
    (grads, CompressionState)``."""
    group = mesh.get_group(axis)

    def reduce_tree(grads, state: CompressionState):
        out = [compressed_allreduce(g, r, group)
               for g, r in zip(leaves(grads), leaves(state.residual))]
        return (unflatten(grads, [o[0] for o in out]),
                CompressionState(unflatten(grads, [o[1] for o in out])))

    return reduce_tree
