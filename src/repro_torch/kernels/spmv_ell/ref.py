"""Plain torch version of the ELL SpMV kernel: what the CUDA kernel
computes, in ordinary tensor ops.  The wrapper in :mod:`.ops` runs it for
tensors on the CPU; on the card it is the yardstick the kernel is held
against."""
from __future__ import annotations

__all__ = ["spmv_ref"]


def spmv_ref(v, cols, vals):
    """``y[i] = sum_k vals[k, i] * v[cols[k, i]]`` for ``v`` of shape
    ``(n_v,)`` or ``(n_v, m)`` (one SpMV per column)."""
    if v.dim() == 2:
        return (vals[..., None] * v[cols]).sum(0)
    return (vals * v[cols]).sum(0)
