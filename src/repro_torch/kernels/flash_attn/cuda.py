"""ctypes wrapper of the CUDA flash-attention kernels (``csrc/flash_attn.cu``).

:func:`flash_attn` launches one kernel per call, on tensor cores
(``mma.sync``) for bf16 and as scalar f32 FMAs for f32, and counts it in
:data:`launches` under ``flash_attn``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import build
from ..cuda_common import I32, P, check_tensor, raise_on_error, stream_of

__all__ = ["flash_attn", "launches", "reset_launches", "MAX_HEAD_DIM",
           "check_prefix"]

launches = {"flash_attn": 0}
MAX_HEAD_DIM = 256
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def check_prefix(prefix_len: int, Sk: int, causal: bool, window: int) -> None:
    """Raise ``ValueError`` unless ``prefix_len`` is in ``[0, Sk]`` and, when
    non-zero, sits on a causal mask without a window (the kernel's own
    check, made before the launch)."""
    if not 0 <= prefix_len <= Sk:
        raise ValueError(f"prefix_len {prefix_len} outside [0, {Sk}]")
    if prefix_len and (not causal or window > 0):
        raise ValueError(f"prefix_len {prefix_len} needs a causal mask without "
                         f"a window (causal={causal}, window={window})")


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(build.load("flash_attn"), f"flash_attn_fwd_{_SUFFIX[dtype]}")
    fn.argtypes = [P, P, P, P] + [I32] * 10 + [ctypes.c_float, ctypes.c_float, P]
    fn.restype = I32
    return fn


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, window: int = 0,
               valid_len: int | None = None, softcap: float = 0.0,
               prefix_len: int = 0) -> torch.Tensor:
    """Attention of ``q`` ``(B, Sq, Hq, hd)`` over ``k``/``v`` ``(B, Sk,
    Hkv, hd)`` on the card, scale ``hd ** -0.5``; returns ``(B, Sq, Hq,
    hd)`` in ``q``'s dtype.  Keys at or past ``valid_len`` (default
    ``Sk``) are dead.  ``softcap > 0`` caps each scaled score at
    ``softcap * tanh(s / softcap)`` before the mask.  ``prefix_len > 0``
    (causal, no window) makes the first ``prefix_len`` keys live for every
    query: the prefix-LM mask ``(k <= q) | (k < prefix_len)``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attn launches the CUDA kernel; q is on {dev}")
    dt = q.dtype
    if dt not in _SUFFIX:
        raise ValueError(f"q: dtype {dt} not supported (float32/bfloat16)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(name, t, device=dev, dtype=dt, dim=4)
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected (B, Sq, Hq, hd) and "
                         "(B, Sk, Hkv, hd) twice")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside [1, {MAX_HEAD_DIM}]")
    if dt == torch.float32 and B * Hq > 65535:
        raise ValueError(f"B * Hq = {B * Hq} exceeds the f32 grid's 65535")
    if -(-Sq // 64) > 65535:
        raise ValueError(f"Sq = {Sq} needs more than 65535 query tiles")
    valid_len = Sk if valid_len is None else int(valid_len)
    if not 0 <= valid_len <= Sk:
        raise ValueError(f"valid_len {valid_len} outside [0, {Sk}]")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    check_prefix(prefix_len, Sk, causal, window)
    if not 0.0 <= softcap < float("inf"):
        raise ValueError(f"softcap {softcap} is not a finite value >= 0")
    o = torch.empty_like(q)
    rc = _entry(dt)(o.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    B, Sq, Sk, Hq, Hkv, hd, valid_len, int(causal), int(window),
                    int(prefix_len), hd ** -0.5, float(softcap), stream_of(dev))
    raise_on_error("flash_attn", rc)
    launches["flash_attn"] += 1
    return o
