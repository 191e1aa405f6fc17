"""ELL SpMV ``y = M v`` on the device of ``v``: the CUDA kernel for
tensors on the card, the plain torch version for tensors on the CPU.

:func:`device_cols` uploads an ELL column slab once, after checking on the
host that every column lies inside the vector it will gather from.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda
from .ref import spmv_ref

__all__ = ["spmv", "device_cols"]


def device_cols(cols: np.ndarray, n_v: int, device: torch.device) -> torch.Tensor:
    """``cols`` as the index tensor of :func:`spmv` on ``device``: int32 for
    the kernel, int64 for torch indexing on the CPU.  Raises ``ValueError``
    when a column lies outside ``[0, n_v)`` — a CUDA gather does not clip."""
    if cols.size and (int(cols.min()) < 0 or int(cols.max()) >= n_v):
        raise ValueError(f"ELL column outside [0, {n_v})")
    dt = np.int32 if device.type == "cuda" else np.int64
    return torch.from_numpy(np.ascontiguousarray(cols, dtype=dt)).to(device)


def spmv(v: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``y[i] = sum_k vals[k, i] * v[cols[k, i]]``; ``v`` is ``(n_v,)`` or
    ``(n_v, m)``, ``cols``/``vals`` ``(K, n)``."""
    if v.is_cuda:
        return cuda.spmv(v, cols, vals)
    if v.device.type == "cpu":
        return spmv_ref(v, cols, vals)
    raise ValueError(f"no SpMV kernel for device {v.device}")
