"""Batched dense diagonal-block apply ``(B, T, T) x (B, T[, m])`` on the
device of ``rhs``: the CUDA kernel for tensors on the card, the plain torch
version for tensors on the CPU.  A batched RHS runs in the kernel too."""
from __future__ import annotations

import torch

from . import cuda
from .ref import block_apply_ref

__all__ = ["block_apply"]


def block_apply(dinv: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``out[b] = dinv[b] @ rhs[b]``, summed in ``rhs``'s dtype."""
    if rhs.is_cuda:
        return cuda.block_apply(dinv, rhs)
    if rhs.device.type == "cpu":
        return block_apply_ref(dinv, rhs)
    raise ValueError(f"no block-apply kernel for device {rhs.device}")
