"""Plain torch version of the fused kernel: the sequential chunk walk over
the permuted layout (same math, ordinary tensor ops)."""
from __future__ import annotations

import torch

__all__ = ["fused_solve_ref"]


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
