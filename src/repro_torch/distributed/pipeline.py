"""GPipe-style pipeline parallelism on ``torch.distributed``: the JAX
package's ``distributed/pipeline.py``.

Schedule: GPipe with M microbatches over P stages; bubble fraction
(P-1)/(M+P-1).  Every rank of the pipeline's group holds one stage's
parameters (the JAX ``P(axis)`` in-spec: rank ``i`` of the group is stage
``i``).  The microbatch stream rotates through the stages by a ring shift
to ``(i + 1) % P``; each rank applies its stage to the activation it
holds.  After M+P-1 ticks every microbatch has passed every stage, and a
sum over the group gives every rank the last stage's outputs.

Both collectives carry gradients, so ``torch.autograd`` reaches every
stage's parameters and the microbatches: the ring shift's backward sends
each cotangent to the previous stage; the closing sum's backward hands
each rank its own output's cotangent, as the JAX transpose of a
replicated output does (the cotangent divided over the axis, then summed
back), so each rank differentiates its own copy of the output.
``remat_stage`` recomputes each stage's activations in the backward pass
(``torch.utils.checkpoint``).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from .collectives import _sum, ring_shift

__all__ = ["gpipe_stage_fn", "make_gpipe"]


class _CollectOutputs(torch.autograd.Function):
    """The sum of ``x`` over ``group``; each rank's cotangent passes back to
    its own ``x`` (the output is replicated, each rank differentiates its
    copy).  ``last`` (the activation the last tick received) gets a zero
    cotangent: it keeps every tick's ring shift in this rank's graph, so
    that every rank runs each shift's backward exchange."""

    @staticmethod
    def forward(ctx, x, last, group):
        ctx.last = (last.shape, last.dtype, last.device)
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.last
        return g, torch.zeros(shape, dtype=dtype, device=device), None


class _Inject(torch.autograd.Function):
    """Stage 0's input ``x``; ``buf``, the activation it received and does
    not use, gets a zero cotangent, so that its ring shift stays in the
    graph."""

    @staticmethod
    def forward(ctx, x, buf):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros_like(g)


def gpipe_stage_fn(stage_apply: Callable, num_stages: int, group=None,
                   *, remat_stage: bool = True):
    """``body(stage_params, microbatches) -> outputs`` for this rank's
    stage (its rank in ``group``).

    ``stage_apply(params, x)``: one stage on one microbatch.
    ``microbatches``: ``(M, mb, ...)``, the same on every rank.
    """
    def apply(params, x):
        if remat_stage:
            return checkpoint(stage_apply, params, x, use_reentrant=False)
        return stage_apply(params, x)

    def body(params, mbs):
        stage = dist.get_rank(group)
        M = mbs.shape[0]
        T = M + num_stages - 1
        # requires grad so that every tick's shift is in every rank's graph,
        # also where a rank holds no activation yet
        buf = torch.zeros_like(mbs[0]).requires_grad_(torch.is_grad_enabled())
        outs = [torch.zeros_like(mbs[0])] * M
        for t in range(T):
            # stage s works on microbatch t - s; stage 0 injects it
            valid = 0 <= t - stage < M
            y = buf
            if valid:
                y = apply(params, _Inject.apply(mbs[t], buf) if stage == 0 else buf)
                if stage == num_stages - 1:
                    outs[t - stage] = y
            buf = ring_shift(y, group)
        # outputs live on the last stage; summed so every rank returns them
        return _CollectOutputs.apply(torch.stack(outs), buf, group)

    return body


def make_gpipe(stage_apply: Callable, mesh, axis: str = "pipe", *,
               num_stages: int | None = None, remat_stage: bool = True):
    """``fn(stage_params, microbatches (M, mb, d)) -> outputs (M, mb, d)``
    over the mesh dimension ``axis``: each rank passes its own stage's
    parameters."""
    group = mesh.get_group(axis)
    P_ = num_stages or dist.get_world_size(group)
    return gpipe_stage_fn(stage_apply, P_, group, remat_stage=remat_stage)
