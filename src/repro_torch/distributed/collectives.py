"""Collectives that carry a gradient, on ``torch.distributed``.

Each is an autograd function whose backward is the transposed collective,
as ``jax.grad`` transposes the collectives of a ``shard_map`` body:

* :func:`all_gather`: the ranks' blocks stacked along dim 0; backward sums
  the cotangent over the group and keeps this rank's block (a
  reduce-scatter);
* :func:`all_to_all`: block ``j`` of dim 0 to rank ``j``; its own
  transpose;
* :func:`all_reduce`: the sum over the group; backward sums the cotangent
  over the group;
* :func:`ring_shift`: each rank's tensor to the next rank of the group
  (``(i + 1) % n``); backward sends the cotangent to the previous one;
* :func:`scale_grad`: the identity, its cotangent scaled.

The forward of each is the plain collective, so a forward pass computes
what it computed before, bit for bit.  Every rank of the group must call
each of them, and run its backward, in the same order (SPMD).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.dist import all_gather_tensor

__all__ = ["all_gather", "all_to_all", "all_reduce", "ring_shift", "scale_grad"]


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    all_gather_tensor(out, x.contiguous(), group=group)
    return out


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _gather0(x, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return _sum(g, ctx.group)[r * ctx.rows:(r + 1) * ctx.rows], None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    # the output is made from the contiguous input: empty_like of a
    # permuted tensor would keep its strides
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """``x`` to rank ``(i + step) % n`` of ``group``; this rank's result
    comes from rank ``(i - step) % n``."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    i = dist.get_rank(group)
    to = dist.get_global_rank(group, (i + step) % n) if group is not None \
        else (i + step) % n
    frm = dist.get_global_rank(group, (i - step) % n) if group is not None \
        else (i - step) % n
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, to, group), dist.P2POp(dist.irecv, out, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """``(a, ...)`` on each of ``n`` ranks → ``(n * a, ...)``, rank ``i``'s
    block at rows ``[i * a, (i + 1) * a)``."""
    return _AllGather.apply(x, group)


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` ``(n, ...)``: slice ``j`` goes to rank ``j`` of ``group``; the
    result's slice ``i`` came from rank ``i``."""
    return _AllToAll.apply(x, group)


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor)."""
    return _AllReduce.apply(x, group)


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """Rank ``i``'s ``x`` at rank ``(i + 1) % n``: the ring ``ppermute``."""
    return _RingShift.apply(x, group)


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x``, its gradient times ``scale``."""
    if scale == 1:
        return x
    return _ScaleGrad.apply(x, scale)
