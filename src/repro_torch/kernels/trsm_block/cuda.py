"""ctypes wrappers of the CUDA block-apply kernels (``csrc/trsm_block.cu``).

:func:`block_apply` launches one batched apply per call and counts it in
:data:`launches` as ``trsm_block_apply`` for ``rhs: (B, T)``,
``trsm_block_apply_batched`` for ``rhs: (B, T, m)``.  :func:`blocked_walk`
launches the whole blocked solve once per call, counted as
``trsm_block_walk`` for ``x: (n,)``, ``trsm_block_walk_batched`` for
``x: (n, m)``; :func:`walk_config` says how that launch is made.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from ..cuda_common import (FLOAT_SUFFIX, I32, I64, P, check_tensor,
                           raise_on_error, stream_of)
from .table import WalkTable

__all__ = ["block_apply", "blocked_walk", "walk_config", "launches",
           "reset_launches", "MAX_SMEM_BYTES"]

launches = {"trsm_block_apply": 0, "trsm_block_apply_batched": 0,
            "trsm_block_walk": 0, "trsm_block_walk_batched": 0}

# Shared memory one thread block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448
# what the walk's host code returns where one diagonal block's Dinv stage
# does not fit (T above ~160 in f64)
_WALK_TOO_BIG = -2


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(build.load("trsm_block"), f"trsm_block_apply_{FLOAT_SUFFIX[dtype]}")
    fn.argtypes = [P, P, P, I64, I32, I32, I32, P]
    fn.restype = I32
    return fn


def block_apply(dinv: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``out[b] = dinv[b] @ rhs[b]`` on the card: ``dinv (B, T, T)`` in
    ``rhs``'s dtype, ``rhs (B, T)`` or ``(B, T, m)``; returns ``out`` shaped
    like ``rhs``.  ``dinv[b]`` is staged in shared memory, so ``T`` is
    bounded by :data:`MAX_SMEM_BYTES`."""
    dev = rhs.device
    if dev.type != "cuda":
        raise ValueError(f"block_apply launches the CUDA kernel; rhs is on {dev}")
    dt = rhs.dtype
    if dt not in FLOAT_SUFFIX:
        raise ValueError(f"rhs: dtype {dt} not supported (float32/float64)")
    check_tensor("dinv", dinv, device=dev, dtype=dt, dim=3)
    check_tensor("rhs", rhs, device=dev, dtype=dt, dim=(2, 3))
    B, T, T2 = dinv.shape
    if T != T2 or tuple(rhs.shape[:2]) != (B, T):
        raise ValueError(f"shape mismatch: dinv {tuple(dinv.shape)}, rhs "
                         f"{tuple(rhs.shape)}")
    if T * (T + 1) * dinv.element_size() > MAX_SMEM_BYTES:
        raise ValueError(f"block size T={T} does not fit in shared memory "
                         f"({dt})")
    if B >= 2 ** 31:
        raise ValueError(f"{B} blocks exceed the grid limit")
    batched = rhs.dim() == 3
    m = rhs.shape[2] if batched else 1
    out = torch.empty_like(rhs)
    rc = _entry(dt)(out.data_ptr(), dinv.data_ptr(), rhs.data_ptr(), B, T,
                    int(batched), m, stream_of(dev))
    raise_on_error("trsm_block_apply", rc)
    launches["trsm_block_apply_batched" if batched else "trsm_block_apply"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _walk_entry(dtype: torch.dtype):
    fn = getattr(build.load("trsm_block"), f"trsm_block_walk_{FLOAT_SUFFIX[dtype]}")
    fn.argtypes = [P, P, P, P, P, P, P, P, I32, I32, I64, I64, P, P]
    fn.restype = I32
    return fn


def _walk_rc(rc: int) -> None:
    if rc == _WALK_TOO_BIG:
        raise ValueError("a diagonal block's inverse does not fit in shared "
                         "memory")
    raise_on_error("trsm_block_walk", rc)


def walk_config(table: WalkTable, m: int, dtype: torch.dtype) -> dict:
    """How :func:`blocked_walk` launches on the current card for ``m`` RHS
    columns: ``cooperative`` (a grid with barriers, else one block per
    column group), ``grid`` blocks, ``smem`` bytes, ``stages`` (2 or 3:
    the next items' copies overlap this one's work), ``barriers`` per
    launch, column ``groups``, ``threads`` per block and ``global_panels``,
    the segments whose panel is too wide to stage and is read from device
    memory.  Cached on the table."""
    key = (m, dtype)
    if key not in table.configs:
        fn = getattr(build.load("trsm_block"),
                     f"trsm_block_walk_config_{FLOAT_SUFFIX[dtype]}")
        fn.argtypes = [P, I32, I32, P]
        fn.restype = I32
        out = (ctypes.c_longlong * 8)()
        _walk_rc(fn(table.host.ctypes.data, table.num_segments, m, out))
        table.configs[key] = dict(zip(
            ("cooperative", "grid", "smem", "stages", "barriers", "groups",
             "threads", "global_panels"), (bool(out[0]), *map(int, out[1:]))))
    return table.configs[key]


def blocked_walk(x: torch.Tensor, bhat: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor, dinv: torch.Tensor,
                 table: WalkTable) -> None:
    """The whole blocked solve in place into ``x`` on the card, one launch.

    ``x`` (zero-filled) and ``bhat``: ``(n[, m])`` in one dtype; ``cols``
    int32 and ``vals`` the flat panel buffers, ``dinv`` the flat inverted
    blocks in ``x``'s dtype; ``table`` on ``x``'s device.  The caller
    guarantees every column position is < n."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"blocked_walk launches the CUDA kernel; x is on {dev}")
    dt = x.dtype
    if dt not in FLOAT_SUFFIX:
        raise ValueError(f"x: dtype {dt} not supported (float32/float64)")
    check_tensor("x", x, device=dev, dtype=dt, dim=(1, 2))
    check_tensor("bhat", bhat, device=dev, dtype=dt, dim=x.dim())
    check_tensor("cols", cols, device=dev, dtype=torch.int32, dim=1)
    check_tensor("vals", vals, device=dev, dtype=dt, dim=1)
    check_tensor("dinv", dinv, device=dev, dtype=dt, dim=1)
    check_tensor("table.dev", table.dev, device=dev, dtype=torch.int64, dim=2)
    check_tensor("table.lane_row", table.lane_row, device=dev,
                 dtype=torch.int32, dim=1)
    if bhat.shape != x.shape:
        raise ValueError(f"bhat {tuple(bhat.shape)} and x {tuple(x.shape)} "
                         "must have one shape")
    need = table.need
    if (x.shape[0] < need["x"] or cols.numel() < need["vals"]
            or vals.numel() < need["vals"] or dinv.numel() < need["dinv"]):
        raise ValueError("the table reaches outside its buffers")
    batched = x.dim() == 2
    m = x.shape[1] if batched else 1
    S = table.num_segments
    if S == 0 or m == 0:
        return
    # the grid barrier's arrival count
    bar = (torch.zeros(1, dtype=torch.int32, device=dev)
           if walk_config(table, m, dt)["cooperative"] else None)
    rc = _walk_entry(dt)(x.data_ptr(), bhat.data_ptr(), cols.data_ptr(),
                         vals.data_ptr(), dinv.data_ptr(),
                         table.host.ctypes.data, table.dev.data_ptr(),
                         table.lane_row.data_ptr(), S, m, x.stride(0),
                         bhat.stride(0), None if bar is None else bar.data_ptr(),
                         stream_of(dev))
    _walk_rc(rc)
    launches["trsm_block_walk_batched" if batched else "trsm_block_walk"] += 1
