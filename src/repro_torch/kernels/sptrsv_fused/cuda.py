"""ctypes wrapper of the CUDA fused kernels (``csrc/sptrsv_fused.cu``).

:func:`fused_solve` launches one kernel per call and counts it in
:data:`launches`, keyed by kernel: ``sptrsv_fused`` for a single RHS
``bl_perm: (n_pad,)`` (a persistent grid whose warps take the groups of a
:class:`~.table.FusedTable` by ticket and wait for each row they read to
be written: ``x̂`` starts as a pending NaN that no written value has),
``sptrsv_fused_batched`` (a cooperative grid over every SM, with a grid
barrier between spans) for ``bl_perm: (n_pad, m)``.  :func:`walk_grid`
and :func:`batched_grid` give the two grids' block counts.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from .. import build
from ..cuda_common import (FLOAT_SUFFIX, I32, I64, P, KernelLaunchError,
                           check_tensor, raise_on_error, stream_of)
from .table import FusedTable

__all__ = ["fused_solve", "walk_grid", "batched_grid", "launches",
           "reset_launches"]

launches = {"sptrsv_fused": 0, "sptrsv_fused_batched": 0}
# Read the walk's error word back after each launch: a wait that ran out
# then raises KernelLaunchError and the launch is not counted.  The read is a
# device-to-host copy that waits for the launch, so the host cannot queue
# the next solve meanwhile; off (the default), a wait that runs out leaves
# the pending NaN in x̂ and raises nothing.  The card tests and
# chip_smoke.py's checks turn it on.
check_waits = False
# x̂ before its row is written (``Bits<T>::kPending`` of the source): a NaN
# that the walk never writes
PENDING = {torch.float32: (torch.int32, 0x7FC0DEAD),
           torch.float64: (torch.int64, 0x7FF8DEADBEEFCAFE)}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(build.load("sptrsv_fused"), f"sptrsv_fused_{FLOAT_SUFFIX[dtype]}")
    fn.argtypes = [P, P, P, P, P, P, I32, I32, I64, I32, I64, I64, P, P]
    fn.restype = I32
    return fn


@functools.lru_cache(maxsize=None)
def _walk_entry(dtype: torch.dtype):
    fn = getattr(build.load("sptrsv_fused"),
                 f"sptrsv_fused_walk_{FLOAT_SUFFIX[dtype]}")
    fn.argtypes = [P, P, P, P, P, P, I32, P, P, I64, P, P]
    fn.restype = I32
    return fn


def _grid(kind: str, dtype: torch.dtype) -> int:
    fn = getattr(build.load("sptrsv_fused"),
                 f"sptrsv_fused_{kind}_{FLOAT_SUFFIX[dtype]}")
    fn.argtypes = [P]
    fn.restype = I32
    blocks = ctypes.c_int(0)
    raise_on_error(f"sptrsv_fused_{kind}", fn(ctypes.byref(blocks)))
    return blocks.value


def batched_grid(dtype: torch.dtype) -> int:
    """Blocks of the batched kernel's grid on the current card: as many as
    can be resident at once (blocks per SM x SMs)."""
    return _grid("grid", dtype)


def walk_grid(dtype: torch.dtype) -> int:
    """Blocks of the single-RHS walk's persistent grid on the current card
    (``kWalkThreads`` threads each)."""
    return _grid("walk_grid", dtype)


def _walk(bl_perm, cols, vals, diag, table: FusedTable) -> torch.Tensor:
    dev, dt = bl_perm.device, bl_perm.dtype
    n_pad = cols.shape[1]
    if table.n_pad != n_pad:
        raise ValueError(f"the table covers {table.n_pad} positions, the "
                         f"layout {n_pad}")
    check_tensor("table.groups", table.groups, device=dev, dtype=torch.int32, dim=2)
    check_tensor("table.row_len", table.row_len, device=dev, dtype=torch.int32, dim=1)
    check_tensor("table.pad_cols", table.pad_cols, device=dev, dtype=torch.int32, dim=2)
    if (table.row_len.shape[0] != n_pad or table.pad_cols.shape != (2, n_pad)
            or table.groups.shape[1] != 2):
        raise ValueError("the table's shapes do not match the layout")
    bits, pending = PENDING[dt]
    x = torch.full((n_pad,), pending, dtype=bits, device=dev).view(dt)
    scratch = torch.zeros(2, dtype=torch.int32, device=dev)  # ticket, error
    rc = _walk_entry(dt)(x.data_ptr(), bl_perm.data_ptr(), cols.data_ptr(),
                         vals.data_ptr(), diag.data_ptr(), table.groups.data_ptr(),
                         table.num_groups, table.row_len.data_ptr(),
                         table.pad_cols.data_ptr(), n_pad, scratch.data_ptr(),
                         stream_of(dev))
    raise_on_error("sptrsv_fused", rc)
    if check_waits and int(scratch[1]):
        raise KernelLaunchError(
            "sptrsv_fused: a wait ran out (a row waited on a position that "
            "no earlier group writes: the table does not match the layout)")
    launches["sptrsv_fused"] += 1
    return x


def fused_solve(bl_perm: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                diag: torch.Tensor, spans: Optional[torch.Tensor] = None,
                table: Optional[FusedTable] = None) -> torch.Tensor:
    """The whole permuted solve on the card: returns ``x̂`` shaped like
    ``bl_perm``.  ``cols`` int32 and ``vals`` ``(K, n_pad)``, ``diag``
    ``(n_pad,)``.  A single RHS ``(n_pad,)`` walks ``table`` (built by
    :func:`~.table.fused_table` from the same layout); under
    :data:`check_waits` a wait that ran out raises ``KernelLaunchError`` and is
    not counted.  A batch
    ``(n_pad, m)`` walks ``spans``, int32 ``(S, 2)`` rows ``(off, r_pad)``
    that tile ``[0, n_pad)`` in order; the caller guarantees every column
    position is < n_pad."""
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
    K, n_pad = cols.shape
    if (vals.shape != cols.shape or diag.shape[0] != n_pad
            or bl_perm.shape[0] != n_pad):
        raise ValueError(
            f"shape mismatch: bl_perm {tuple(bl_perm.shape)}, cols "
            f"{tuple(cols.shape)}, vals {tuple(vals.shape)}, diag "
            f"{tuple(diag.shape)}")
    if bl_perm.dim() == 1:
        if table is None:
            raise ValueError("a single-RHS fused solve walks a FusedTable")
        return _walk(bl_perm, cols, vals, diag, table)
    if spans is None:
        raise ValueError("a batched fused solve walks spans")
    check_tensor("spans", spans, device=dev, dtype=torch.int32, dim=2)
    if spans.shape[1] != 2:
        raise ValueError(f"spans: shape {tuple(spans.shape)}, expected (S, 2)")
    m = bl_perm.shape[1]
    x = torch.empty_like(bl_perm)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)  # the grid barrier's count
    rc = _entry(dt)(x.data_ptr(), bl_perm.data_ptr(), cols.data_ptr(),
                    vals.data_ptr(), diag.data_ptr(), spans.data_ptr(),
                    spans.shape[0], K, n_pad, m, x.stride(0),
                    bl_perm.stride(0), bar.data_ptr(), stream_of(dev))
    raise_on_error("sptrsv_fused", rc)
    launches["sptrsv_fused_batched"] += 1
    return x
