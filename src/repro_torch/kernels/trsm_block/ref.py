"""Plain torch version of the block-apply kernel: what the CUDA kernel
computes, in ordinary tensor ops.  The wrapper in :mod:`.ops` runs it for
tensors on the CPU; on the card it is the yardstick the kernel is held
against."""
from __future__ import annotations

import torch

__all__ = ["block_apply_ref"]


def block_apply_ref(dinv, rhs):
    """``out[b] = dinv[b] @ rhs[b]`` for ``dinv (B, T, T)`` and ``rhs``
    ``(B, T)`` or ``(B, T, m)``, summed in ``rhs``'s dtype."""
    if rhs.dim() == 2:
        return torch.einsum("bij,bj->bi", dinv, rhs)
    return torch.einsum("bij,bjm->bim", dinv, rhs)
