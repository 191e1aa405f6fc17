"""ctypes wrapper of the CUDA level kernels (``csrc/sptrsv_level.cu``).

:func:`level_walk` launches one kernel per row of a :class:`LevelTable` —
a plain segment over as many blocks as it needs, a coarsened chain on one
block that walks its sub-steps — a whole solve from one call.  It counts
every launch in :data:`launches`, keyed by kernel: ``sptrsv_level`` for a
single RHS ``x: (n_x,)``, ``sptrsv_level_batched`` for ``x: (n_x, m)``;
and in :data:`launch_kinds` by variant (:meth:`LevelTable.kinds`).

:func:`level_scatter` runs the scatter layout's solve, one step per
wavefront of a :class:`ScatterTable` (a level kernel and its row scatter),
and counts each step as ``sptrsv_level_scatter`` for ``x: (n_pad,)``,
``sptrsv_level_scatter_batched`` for ``x: (n_pad, m)``.
"""
from __future__ import annotations

import functools

import torch

from .. import build
from ..cuda_common import (FLOAT_SUFFIX, I32, I64, P, check_tensor,
                           raise_on_error, stream_of)
from .table import LevelTable, ScatterTable

__all__ = ["level_walk", "level_scatter", "launches", "launch_kinds",
           "reset_launches"]

launches = {"sptrsv_level": 0, "sptrsv_level_batched": 0,
            "sptrsv_level_scatter": 0, "sptrsv_level_scatter_batched": 0}
launch_kinds = {"segment": 0, "segment_warp": 0, "chain": 0, "chain_warp": 0}


def reset_launches() -> None:
    for counts in (launches, launch_kinds):
        for k in counts:
            counts[k] = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(build.load("sptrsv_level"),
                 f"sptrsv_level_walk_{FLOAT_SUFFIX[dtype]}")
    fn.argtypes = [P, P, P, P, P, P, P, P, I32, I32, I32, I64, I64, P]
    fn.restype = I32
    return fn


def level_walk(x: torch.Tensor, bhat: torch.Tensor, cols: torch.Tensor,
               vals: torch.Tensor, diag: torch.Tensor,
               table: LevelTable) -> None:
    """Run the table's segments in place into ``x`` on the card.

    ``x``: ``(n_x[, m])``; ``bhat``: ``(n_b[, m])``; ``cols`` int32,
    ``vals`` and ``diag`` flat packed buffers in ``x``'s dtype; ``table``
    on ``x``'s device.  The caller guarantees every column position is
    < n_x."""
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
    check_tensor("table.row_len", table.row_len, device=dev,
                 dtype=torch.int32, dim=1)
    check_tensor("table.sub_offs_dev", table.sub_offs_dev, device=dev,
                 dtype=torch.int64, dim=1)
    batched = x.dim() == 2
    m = x.shape[1] if batched else 1
    if batched and bhat.shape[1] != m:
        raise ValueError(f"bhat has {bhat.shape[1]} columns, x has {m}")
    if cols.numel() != vals.numel():
        raise ValueError("cols and vals must be packed alike")
    need = table.need
    if (min(x.shape[0], bhat.shape[0]) < need["x"]
            or vals.numel() < need["vals"] or diag.numel() < need["diag"]):
        raise ValueError("the table reaches outside its buffers")
    S = table.num_segments
    if S == 0:
        return
    rc = _entry(dt)(x.data_ptr(), bhat.data_ptr(), cols.data_ptr(),
                    vals.data_ptr(), diag.data_ptr(), table.row_len.data_ptr(),
                    table.sub_offs_dev.data_ptr(), table.host.ctypes.data, S,
                    int(batched), m, x.stride(0), bhat.stride(0),
                    stream_of(dev))
    raise_on_error("sptrsv_level", rc)
    launches["sptrsv_level_batched" if batched else "sptrsv_level"] += S
    for k, n in table.kinds().items():
        launch_kinds[k] += n


@functools.lru_cache(maxsize=None)
def _scatter_entry(dtype: torch.dtype):
    fn = getattr(build.load("sptrsv_level"),
                 f"sptrsv_level_scatter_{FLOAT_SUFFIX[dtype]}")
    fn.argtypes = [P, P, P, P, P, P, P, P, I32, I32, I32, I64, I64, P]
    fn.restype = I32
    return fn


def level_scatter(x: torch.Tensor, b_ext: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor, vals: torch.Tensor, diag: torch.Tensor,
                  table: ScatterTable) -> None:
    """Run the table's steps in place into ``x`` on the card.

    ``x``: ``(n_pad[, m])`` with the scratch slot at ``table.n``;
    ``b_ext``: ``(n + 1[, m])``, its last row zero; ``rows`` and ``cols``
    int32 (every row id <= n, every column < n_pad); ``vals`` and ``diag``
    flat step buffers in ``x``'s dtype."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"level_scatter launches the CUDA kernel; x is on {dev}")
    dt = x.dtype
    if dt not in FLOAT_SUFFIX:
        raise ValueError(f"x: dtype {dt} not supported (float32/float64)")
    check_tensor("x", x, device=dev, dtype=dt, dim=(1, 2))
    check_tensor("b_ext", b_ext, device=dev, dtype=dt, dim=x.dim())
    check_tensor("rows", rows, device=dev, dtype=torch.int32, dim=1)
    check_tensor("cols", cols, device=dev, dtype=torch.int32, dim=1)
    check_tensor("vals", vals, device=dev, dtype=dt, dim=1)
    check_tensor("diag", diag, device=dev, dtype=dt, dim=1)
    batched = x.dim() == 2
    m = x.shape[1] if batched else 1
    if batched and b_ext.shape[1] != m:
        raise ValueError(f"b_ext has {b_ext.shape[1]} columns, x has {m}")
    need = table.need
    if (x.shape[0] <= table.n or b_ext.shape[0] <= table.n
            or min(cols.numel(), vals.numel()) < need["vals"]
            or min(rows.numel(), diag.numel()) < need["diag"]):
        raise ValueError("the table reaches outside its buffers")
    S = table.num_steps
    if S == 0 or m == 0:
        return
    xl = torch.empty(need["xl"] * m, dtype=dt, device=dev)
    rc = _scatter_entry(dt)(x.data_ptr(), b_ext.data_ptr(), rows.data_ptr(),
                            cols.data_ptr(), vals.data_ptr(), diag.data_ptr(),
                            xl.data_ptr(), table.host.ctypes.data, S, table.n,
                            m, x.stride(0), b_ext.stride(0), stream_of(dev))
    raise_on_error("sptrsv_level_scatter", rc)
    launches["sptrsv_level_scatter_batched" if batched
             else "sptrsv_level_scatter"] += S
