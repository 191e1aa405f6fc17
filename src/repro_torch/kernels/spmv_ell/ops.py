"""ELL SpMV ``y = M v`` on the device of ``v``: the CUDA kernel for
tensors on the card, the plain torch version for tensors on the CPU.

:func:`device_cols` uploads an ELL column slab once, after checking on the
host that every column lies inside the vector it will gather from;
:func:`device_row_len` uploads the slab's row lengths for the kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import cuda
from .ref import spmv_ref

__all__ = ["spmv", "device_cols", "device_row_len"]


def device_cols(cols: np.ndarray, n_v: int, device: torch.device) -> torch.Tensor:
    """``cols`` as the index tensor of :func:`spmv` on ``device``: int32 for
    the kernel, int64 for torch indexing on the CPU.  Raises ``ValueError``
    when a column lies outside ``[0, n_v)`` — a CUDA gather does not clip."""
    if cols.size and (int(cols.min()) < 0 or int(cols.max()) >= n_v):
        raise ValueError(f"ELL column outside [0, {n_v})")
    dt = np.int32 if device.type == "cuda" else np.int64
    return torch.from_numpy(np.ascontiguousarray(cols, dtype=dt)).to(device)


def device_row_len(row_nnz: np.ndarray, cols: np.ndarray,
                   device: torch.device) -> Optional[torch.Tensor]:
    """The row lengths of the ELL slab ``cols`` ``(K, n)`` as the kernel's
    int32 ``(n,)`` tensor on a card, ``None`` on the CPU (the plain version
    walks every slot).  Raises ``ValueError`` unless each length lies in
    ``[0, K]`` and every slot past it is a pad (col 0)."""
    K, n = cols.shape
    row_nnz = np.asarray(row_nnz)
    if row_nnz.shape != (n,) or (n and (row_nnz.min() < 0 or row_nnz.max() > K)):
        raise ValueError(f"row lengths outside [0, {K}]")
    if (cols[np.arange(K)[:, None] >= row_nnz[None, :]] != 0).any():
        raise ValueError("an ELL slot past its row length is not a pad")
    if device.type != "cuda":
        return None
    return torch.from_numpy(row_nnz.astype(np.int32)).to(device)


def spmv(v: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
         row_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y[i] = sum_k vals[k, i] * v[cols[k, i]]``; ``v`` is ``(n_v,)`` or
    ``(n_v, m)``, ``cols``/``vals`` ``(K, n)``.  ``row_len`` (from
    :func:`device_row_len`) lets the kernel skip each row's pads; the plain
    version needs none."""
    if v.is_cuda:
        return cuda.spmv(v, cols, vals, row_len)
    if v.device.type == "cpu":
        return spmv_ref(v, cols, vals)
    raise ValueError(f"no SpMV kernel for device {v.device}")
