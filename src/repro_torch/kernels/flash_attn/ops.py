"""Flash attention on the device of ``q``: the CUDA kernel for tensors on
the card, the plain torch version for tensors on the CPU.

The JAX wrapper's TPU-only steps (repeating KV heads, padding S to the
128-row block and hd to 128 with a q rescale) are not copied: the kernel
reads KV head ``h // (Hq // Hkv)`` itself and masks the ragged edge.

Where a gradient is wanted (grad mode on and ``q``, ``k`` or ``v``
requiring one), the call goes through :class:`FlashAttention`: its forward
is the same kernel launch, and its backward recomputes the attention with
the plain version and differentiates that.  The JAX package has no
backward kernel (it trains through its plain-JAX attention), so none is
ported; the backward is plain torch by design.
"""
from __future__ import annotations

import torch

from . import cuda
from .ref import gqa_attention_ref

__all__ = ["flash_attention_kernel", "FlashAttention"]


def _forward(q, k, v, causal, window, softcap, prefix_len):
    if q.is_cuda:
        return cuda.flash_attn(q, k, v, causal=causal, window=window,
                               softcap=softcap, prefix_len=prefix_len)
    if q.device.type == "cpu":
        cuda.check_prefix(prefix_len, k.shape[1], causal, window)
        return gqa_attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, prefix_len=prefix_len)
    raise ValueError(f"no flash-attention kernel for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """The flash kernel's forward (the plain version on the CPU), with the
    gradient of the plain version, recomputed from the saved ``q``, ``k``,
    ``v``: every mask of the kernel (causal, window, full, cross ``Sq !=
    Sk``, GQA, softcap, prefix)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, prefix_len):
        ctx.save_for_backward(q, k, v)
        ctx.mask = dict(causal=causal, window=window, softcap=softcap,
                        prefix_len=prefix_len)
        return _forward(q, k, v, causal, window, softcap, prefix_len)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = gqa_attention_ref(*qkv, **ctx.mask)
            dq, dk, dv = torch.autograd.grad(o, qkv, grad_out)
        return dq, dk, dv, None, None, None, None


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, window: int = 0,
                           softcap: float = 0.0,
                           prefix_len: int = 0) -> torch.Tensor:
    """``q``: ``(B, Sq, Hq, hd)``, ``k``/``v``: ``(B, Sk, Hkv, hd)`` →
    ``(B, Sq, Hq, hd)`` in ``q``'s dtype; ``softcap > 0`` caps the scaled
    scores before the mask; ``prefix_len > 0`` (causal, no window) makes
    the first ``prefix_len`` keys live for every query.  Differentiable
    (:class:`FlashAttention`) where a gradient is wanted; otherwise one
    kernel launch and nothing saved."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap, prefix_len)
    return _forward(q, k, v, causal, window, softcap, prefix_len)
