"""ctypes wrapper of the CUDA ELL SpMV kernel (``csrc/spmv_ell.cu``).

:func:`spmv` launches the kernel once per call and counts it in
:data:`launches`, keyed by kernel: ``spmv_ell`` for a single vector
``v: (n_v,)``, ``spmv_ell_batched`` for ``v: (n_v, m)``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import build
from ..cuda_common import (FLOAT_SUFFIX, I32, I64, P, check_tensor,
                           raise_on_error, stream_of)

__all__ = ["spmv", "launches", "reset_launches"]

launches = {"spmv_ell": 0, "spmv_ell_batched": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(build.load("spmv_ell"), f"spmv_ell_{FLOAT_SUFFIX[dtype]}")
    fn.argtypes = [P, P, P, P, P, I32, I64, I32, I32, I64, I64, P]
    fn.restype = I32
    return fn


def spmv(v: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
         row_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = M v`` on the card for the ELL slab ``cols`` (int32) / ``vals``
    (``v``'s dtype), both ``(K, n)``; returns ``y`` of shape ``(n,)`` or
    ``(n, m)`` like ``v``.  The caller guarantees every column is < n_v
    (:func:`repro_torch.kernels.spmv_ell.ops.device_cols` checks it).

    ``row_len`` (int32 ``(n,)``, each in ``[0, K]``, the slots past it ELL
    pads of col 0 and val 0; :func:`~.ops.device_row_len` checks it) lets
    a row read only its real entries; the result is the same."""
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"spmv launches the CUDA kernel; v is on {dev}")
    dt = v.dtype
    if dt not in FLOAT_SUFFIX:
        raise ValueError(f"v: dtype {dt} not supported (float32/float64)")
    check_tensor("v", v, device=dev, dtype=dt, dim=(1, 2))
    check_tensor("cols", cols, device=dev, dtype=torch.int32, dim=2)
    check_tensor("vals", vals, device=dev, dtype=dt, dim=2)
    if vals.shape != cols.shape:
        raise ValueError(f"cols {tuple(cols.shape)} and vals "
                         f"{tuple(vals.shape)} must have one shape")
    K, n = cols.shape
    if row_len is not None:
        check_tensor("row_len", row_len, device=dev, dtype=torch.int32, dim=1)
        if row_len.shape[0] != n:
            raise ValueError(f"row_len has {row_len.shape[0]} rows, the slab {n}")
    batched = v.dim() == 2
    m = v.shape[1] if batched else 1
    y = torch.empty((n, m) if batched else (n,), dtype=dt, device=dev)
    rc = _entry(dt)(y.data_ptr(), v.data_ptr(), cols.data_ptr(),
                    vals.data_ptr(),
                    None if row_len is None else row_len.data_ptr(), K, n,
                    int(batched), m, v.stride(0), y.stride(0), stream_of(dev))
    raise_on_error("spmv_ell", rc)
    launches["spmv_ell_batched" if batched else "spmv_ell"] += 1
    return y
