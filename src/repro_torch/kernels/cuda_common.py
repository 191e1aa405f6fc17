"""Argument checks shared by the ctypes kernel wrappers.

A kernel takes raw pointers, so its wrapper checks everything the kernel
assumes — device, dtype, rank, contiguity — and raises ``ValueError`` on
anything it does not take, before any pointer leaves Python.  A launch
that fails, or a kernel that reports a fault of its own, raises
:class:`KernelLaunchError`: the card's state is then not to be trusted, so
callers that isolate a request's failure (the serving engine) re-raise it.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["FLOAT_SUFFIX", "KernelLaunchError", "check_tensor", "stream_of",
           "raise_on_error", "P", "I32", "I64"]

FLOAT_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong


class KernelLaunchError(RuntimeError):
    """A CUDA kernel failed to launch or reported a fault while it ran."""


def check_tensor(name: str, t: torch.Tensor, *, device: torch.device,
                 dtype: torch.dtype, dim) -> None:
    """``t`` must be a contiguous CUDA tensor on ``device`` of ``dtype``
    with rank in ``dim`` (an int or a tuple of ints)."""
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    if not torch.is_tensor(t):
        raise ValueError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() not in dims:
        raise ValueError(f"{name}: rank {t.dim()}, expected one of {dims}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_of(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device`` — kernels launch
    there and do not synchronise."""
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(kernel: str, rc: int) -> None:
    if rc != 0:
        raise KernelLaunchError(f"{kernel}: CUDA launch failed with error {rc}")
