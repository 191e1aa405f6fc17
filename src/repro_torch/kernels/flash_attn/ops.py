"""Flash attention on the device of ``q``: the CUDA kernel for tensors on
the card, the plain torch version for tensors on the CPU.

The JAX wrapper's TPU-only steps (repeating KV heads, padding S to the
128-row block and hd to 128 with a q rescale) are not copied: the kernel
reads KV head ``h // (Hq // Hkv)`` itself and masks the ragged edge.
"""
from __future__ import annotations

import torch

from . import cuda
from .ref import gqa_attention_ref

__all__ = ["flash_attention_kernel"]


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, window: int = 0,
                           softcap: float = 0.0,
                           prefix_len: int = 0) -> torch.Tensor:
    """``q``: ``(B, Sq, Hq, hd)``, ``k``/``v``: ``(B, Sk, Hkv, hd)`` →
    ``(B, Sq, Hq, hd)`` in ``q``'s dtype; ``softcap > 0`` caps the scaled
    scores before the mask; ``prefix_len > 0`` (causal, no window) makes
    the first ``prefix_len`` keys live for every query."""
    if q.is_cuda:
        return cuda.flash_attn(q, k, v, causal=causal, window=window,
                               softcap=softcap, prefix_len=prefix_len)
    if q.device.type == "cpu":
        cuda.check_prefix(prefix_len, k.shape[1], causal, window)
        return gqa_attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, prefix_len=prefix_len)
    raise ValueError(f"no flash-attention kernel for device {q.device}")
