"""The blocked solve's kernels on the device of their tensors: the CUDA
kernel for tensors on the card, the plain torch version for tensors on the
CPU.  :func:`block_apply` is one batched dense diagonal-block apply
``(B, T, T) x (B, T[, m])`` (:func:`make_block_apply` returns it for the
scatter layout's blocked solve, one launch per super-level);
:func:`blocked_walk` is the whole blocked solve over a
:class:`~.table.WalkTable`."""
from __future__ import annotations

import torch

from . import cuda
from .ref import block_apply_ref, blocked_walk_ref
from .table import WalkTable, make_walk_table

__all__ = ["block_apply", "make_block_apply", "blocked_walk", "WalkTable",
           "make_walk_table"]


def block_apply(dinv: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``out[b] = dinv[b] @ rhs[b]``, summed in ``rhs``'s dtype."""
    if rhs.is_cuda:
        return cuda.block_apply(dinv, rhs)
    if rhs.device.type == "cpu":
        return block_apply_ref(dinv, rhs)
    raise ValueError(f"no block-apply kernel for device {rhs.device}")


def make_block_apply():
    """The batched diagonal-block apply of the scatter layout's blocked
    solve: :func:`block_apply`, one launch of the block-apply kernel per
    call on the card for ``(B, T)`` and ``(B, T, m)`` alike, its plain
    version on the CPU (the JAX package's choice between Pallas and
    ``dot_general`` has no counterpart: the port always runs its kernel on
    the card)."""
    return block_apply


def blocked_walk(x: torch.Tensor, bhat: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor, dinv: torch.Tensor,
                 table: WalkTable) -> None:
    """Every segment of ``table`` in order, in place into the zero-filled
    ``x``: ``x[off + r] = (Dinv (bhat - Panel x))[lane of r]``."""
    if x.is_cuda:
        return cuda.blocked_walk(x, bhat, cols, vals, dinv, table)
    if x.device.type == "cpu":
        return blocked_walk_ref(x, bhat, cols, vals, dinv, table)
    raise ValueError(f"no blocked-walk kernel for device {x.device}")
