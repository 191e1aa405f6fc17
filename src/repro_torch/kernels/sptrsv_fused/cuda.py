"""ctypes wrapper of the CUDA fused kernel (``csrc/sptrsv_fused.cu``).

:func:`fused_solve` launches the span walk once per call and counts it in
:data:`launches`, keyed by kernel: ``sptrsv_fused`` (one block) for a
single RHS ``bl_perm: (n_pad,)``, ``sptrsv_fused_batched`` (a cooperative
grid over every SM, with a grid barrier between spans) for ``bl_perm:
(n_pad, m)``.  :func:`batched_grid` gives that grid's block count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from ..cuda_common import (FLOAT_SUFFIX, I32, I64, P, check_tensor,
                           raise_on_error, stream_of)

__all__ = ["fused_solve", "batched_grid", "launches", "reset_launches"]

launches = {"sptrsv_fused": 0, "sptrsv_fused_batched": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(build.load("sptrsv_fused"), f"sptrsv_fused_{FLOAT_SUFFIX[dtype]}")
    fn.argtypes = [P, P, P, P, P, P, I32, I32, I64, I32, I32, I64, I64, P, P]
    fn.restype = I32
    return fn


def batched_grid(dtype: torch.dtype) -> int:
    """Blocks of the batched kernel's grid on the current card: as many as
    can be resident at once (blocks per SM x SMs)."""
    fn = getattr(build.load("sptrsv_fused"), f"sptrsv_fused_grid_{FLOAT_SUFFIX[dtype]}")
    fn.argtypes = [P]
    fn.restype = I32
    blocks = ctypes.c_int(0)
    raise_on_error("sptrsv_fused_grid", fn(ctypes.byref(blocks)))
    return blocks.value


def fused_solve(bl_perm: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                diag: torch.Tensor, spans: torch.Tensor) -> torch.Tensor:
    """The whole permuted solve on the card: returns ``x̂`` shaped like
    ``bl_perm``.  ``cols`` int32 and ``vals`` ``(K, n_pad)``, ``diag``
    ``(n_pad,)``, ``spans`` int32 ``(S, 2)`` rows ``(off, r_pad)`` that tile
    ``[0, n_pad)`` in order; the caller guarantees every column position is
    < n_pad."""
    dev = bl_perm.device
    if dev.type != "cuda":
        raise ValueError(f"fused_solve launches the CUDA kernel; bl_perm is on {dev}")
    dt = bl_perm.dtype
    if dt not in FLOAT_SUFFIX:
        raise ValueError(f"bl_perm: dtype {dt} not supported (float32/float64)")
    check_tensor("bl_perm", bl_perm, device=dev, dtype=dt, dim=(1, 2))
    check_tensor("cols", cols, device=dev, dtype=torch.int32, dim=2)
    check_tensor("vals", vals, device=dev, dtype=dt, dim=2)
    check_tensor("diag", diag, device=dev, dtype=dt, dim=1)
    check_tensor("spans", spans, device=dev, dtype=torch.int32, dim=2)
    K, n_pad = cols.shape
    if (vals.shape != cols.shape or diag.shape[0] != n_pad
            or bl_perm.shape[0] != n_pad or spans.shape[1] != 2):
        raise ValueError(
            f"shape mismatch: bl_perm {tuple(bl_perm.shape)}, cols "
            f"{tuple(cols.shape)}, vals {tuple(vals.shape)}, diag "
            f"{tuple(diag.shape)}, spans {tuple(spans.shape)}")
    batched = bl_perm.dim() == 2
    m = bl_perm.shape[1] if batched else 1
    x = torch.empty_like(bl_perm)
    # the grid barrier's arrival count
    bar = torch.zeros(1, dtype=torch.int32, device=dev) if batched else None
    rc = _entry(dt)(x.data_ptr(), bl_perm.data_ptr(), cols.data_ptr(),
                    vals.data_ptr(), diag.data_ptr(), spans.data_ptr(),
                    spans.shape[0], K, n_pad, int(batched), m, x.stride(0),
                    bl_perm.stride(0), None if bar is None else bar.data_ptr(),
                    stream_of(dev))
    raise_on_error("sptrsv_fused", rc)
    launches["sptrsv_fused_batched" if batched else "sptrsv_fused"] += 1
    return x
