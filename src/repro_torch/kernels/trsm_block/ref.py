"""Plain torch versions of the block-apply kernels: what the CUDA kernels
compute, in ordinary tensor ops.  The wrappers in :mod:`.ops` run them for
tensors on the CPU; on the card they are the yardstick the kernels are
held against."""
from __future__ import annotations

import torch

from ..spmv_ell.ref import spmv_ref

__all__ = ["block_apply_ref", "blocked_walk_ref"]


def block_apply_ref(dinv, rhs):
    """``out[b] = dinv[b] @ rhs[b]`` for ``dinv (B, T, T)`` and ``rhs``
    ``(B, T)`` or ``(B, T, m)``, summed in ``rhs``'s dtype."""
    if rhs.dim() == 2:
        return torch.einsum("bij,bj->bi", dinv, rhs)
    return torch.einsum("bij,bjm->bim", dinv, rhs)


def blocked_walk_ref(x, bhat, cols, vals, dinv, table) -> None:
    """The whole blocked solve in place into ``x`` (zero-filled, ``(n,)`` or
    ``(n, m)``), segment by segment of ``table``
    (:class:`~repro_torch.kernels.trsm_block.table.WalkTable`): the panel
    SpMV ``s = Panel x``, ``rhs = -s`` plus ``bhat`` on the real lanes, the
    batched diagonal-block apply, and the real lanes written to
    ``x[off : off + R]`` — what
    :func:`repro_torch.kernels.trsm_block.cuda.blocked_walk` does on the
    card in one launch.  ``cols`` are int64 positions."""
    tail = tuple(x.shape[1:])
    for off, R, B, T, K, voff, doff, _ in table.host.tolist():
        BT = B * T
        span = slice(voff, voff + K * BT)
        lane = table.row_lane[off: off + R]
        # rhs = b - s on the real lanes, -s on the pads: -s + b is exactly
        # b - s in IEEE arithmetic
        rhs = spmv_ref(x, cols[span].view(K, BT), vals[span].view(K, BT)).neg_()
        rhs.index_add_(0, lane, bhat[off: off + R])
        xb = block_apply_ref(dinv[doff: doff + BT * T].view(B, T, T),
                             rhs.view((B, T) + tail))
        torch.index_select(xb.view((BT,) + tail), 0, lane, out=x[off: off + R])
