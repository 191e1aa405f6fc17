"""ctypes wrapper of the CUDA block-apply kernel (``csrc/trsm_block.cu``).

:func:`block_apply` launches the kernel once per call and counts it in
:data:`launches`, keyed by kernel: ``trsm_block_apply`` for
``rhs: (B, T)``, ``trsm_block_apply_batched`` for ``rhs: (B, T, m)``.
"""
from __future__ import annotations

import functools

import torch

from .. import build
from ..cuda_common import (FLOAT_SUFFIX, I32, I64, P, check_tensor,
                           raise_on_error, stream_of)

__all__ = ["block_apply", "launches", "reset_launches", "MAX_SMEM_BYTES"]

launches = {"trsm_block_apply": 0, "trsm_block_apply_batched": 0}

# Shared memory one thread block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448


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
