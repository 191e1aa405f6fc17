"""ctypes wrapper of the CUDA level kernel (``csrc/sptrsv_level.cu``).

:func:`level_walk` launches one level kernel per row of a host step table
``(o, K, R_pad, val_off, diag_off)`` — a whole solve's wavefronts from one
call — and counts every launch in :data:`launches`, keyed by kernel:
``sptrsv_level`` for a single RHS ``x: (n_x,)``, ``sptrsv_level_batched``
for ``x: (n_x, m)``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import build
from ..cuda_common import (FLOAT_SUFFIX, I32, I64, P, check_tensor,
                           raise_on_error, stream_of)

__all__ = ["level_walk", "launches", "reset_launches"]

launches = {"sptrsv_level": 0, "sptrsv_level_batched": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(build.load("sptrsv_level"),
                 f"sptrsv_level_walk_{FLOAT_SUFFIX[dtype]}")
    fn.argtypes = [P, P, P, P, P, P, I32, I32, I32, I64, I64, P]
    fn.restype = I32
    return fn


def level_walk(x: torch.Tensor, bhat: torch.Tensor, cols: torch.Tensor,
               vals: torch.Tensor, diag: torch.Tensor,
               steps: np.ndarray) -> None:
    """Run the wavefront steps in place into ``x`` on the card.

    ``x``: ``(n_x[, m])``; ``bhat``: ``(n_b[, m])``; ``cols`` int32,
    ``vals`` and ``diag`` flat packed buffers in ``x``'s dtype; ``steps``
    a C-contiguous int64 ``(S, 5)`` host array.  Every step must lie inside
    the buffers; the caller guarantees every column position is < n_x."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"level_walk launches the CUDA kernel; x is on {dev}")
    dt = x.dtype
    if dt not in FLOAT_SUFFIX:
        raise ValueError(f"x: dtype {dt} not supported (float32/float64)")
    check_tensor("x", x, device=dev, dtype=dt, dim=(1, 2))
    check_tensor("bhat", bhat, device=dev, dtype=dt, dim=x.dim())
    check_tensor("cols", cols, device=dev, dtype=torch.int32, dim=1)
    check_tensor("vals", vals, device=dev, dtype=dt, dim=1)
    check_tensor("diag", diag, device=dev, dtype=dt, dim=1)
    batched = x.dim() == 2
    m = x.shape[1] if batched else 1
    if batched and bhat.shape[1] != m:
        raise ValueError(f"bhat has {bhat.shape[1]} columns, x has {m}")
    if cols.numel() != vals.numel():
        raise ValueError("cols and vals must be packed alike")
    if not (isinstance(steps, np.ndarray) and steps.dtype == np.int64
            and steps.ndim == 2 and steps.shape[1] == 5
            and steps.flags.c_contiguous):
        raise ValueError("steps must be a C-contiguous int64 (S, 5) array")
    if steps.shape[0] == 0:
        return
    o, K, Rp, voff, doff = steps.T
    if (o.min() < 0 or (o + Rp).max() > min(x.shape[0], bhat.shape[0])
            or (voff + K * Rp).max() > vals.numel()
            or (doff + Rp).max() > diag.numel()):
        raise ValueError("a step reaches outside its buffers")
    rc = _entry(dt)(x.data_ptr(), bhat.data_ptr(), cols.data_ptr(),
                    vals.data_ptr(), diag.data_ptr(), steps.ctypes.data,
                    steps.shape[0], int(batched), m, x.stride(0),
                    bhat.stride(0), stream_of(dev))
    raise_on_error("sptrsv_level", rc)
    launches["sptrsv_level_batched" if batched else "sptrsv_level"] += \
        steps.shape[0]
