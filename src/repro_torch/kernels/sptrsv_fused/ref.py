"""Plain torch versions of the fused kernels: the sequential chunk walk over
the permuted layout (same math, ordinary tensor ops), and the single-RHS
walk of a :class:`~.table.FusedTable` group by group."""
from __future__ import annotations

import torch

from .table import FusedTable

__all__ = ["fused_solve_ref", "fused_walk_ref"]


def fused_solve_ref(bl_perm, cols, vals, diag, *, chunk: int = 512):
    """Single- or multi-RHS (bl_perm (n_pad,) or (n_pad, m)) plain walk."""
    K, n_pad = cols.shape
    batched = bl_perm.dim() == 2
    x = torch.zeros_like(bl_perm)
    for c in range(n_pad // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        v = vals[:, sl, None] if batched else vals[:, sl]
        d = diag[sl, None] if batched else diag[sl]
        s = (v * x[cols[:, sl]]).sum(0)
        x[sl] = (bl_perm[sl] - s) / d
    return x


def fused_walk_ref(bl, cols, vals, diag, table: FusedTable):
    """What the single-RHS CUDA walk computes, one group at a time in
    ticket order: row ``p`` takes its first ``row_len[p]`` ELL terms and
    ``0 * x̂[c]`` for each of its ``pad_cols``,

        x̂[p] = (bl[p] - Σ_k vals[k, p] x̂[cols[k, p]] - Σ_c 0 x̂[c]) / diag[p]

    ``bl`` ``(n_pad,)``; ``cols`` ``(K, n_pad)`` int32 or int64."""
    x = torch.zeros_like(bl)
    row_len, pad_cols = table.row_len.long(), table.pad_cols.long()
    for p0, r in table.host_groups.tolist():
        rows = slice(p0, p0 + r)
        n = row_len[rows]
        k = int(n.max())
        live = torch.arange(k, device=bl.device)[:, None] < n[None, :]
        terms = torch.where(live, vals[:k, rows] * x[cols[:k, rows].long()], 0)
        pc = pad_cols[:, rows]
        pads = torch.where(pc >= 0, 0 * x[pc.clamp_min(0)], 0)
        x[rows] = (bl[rows] - terms.sum(0) - pads.sum(0)) / diag[rows]
    return x
