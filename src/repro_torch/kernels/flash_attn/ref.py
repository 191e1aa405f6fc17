"""Plain torch version of the flash-attention kernel: what the CUDA kernel
computes, in ordinary tensor ops (the whole score matrix at once).  The
wrapper in :mod:`.ops` runs it for tensors on the CPU; on the card it is
the yardstick the kernel is held against."""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "attention_ref", "gqa_attention_ref"]

NEG_INF = -1e30


def attention_ref(q, k, v, valid_len=None, *, causal=True, window=0, softcap=0.0,
                  prefix_len=0):
    """``q``: ``(BH, Sq, hd)``, ``k``/``v``: ``(BH, Sk, hd)`` →
    ``(BH, Sq, hd)`` in ``q``'s dtype; f32 math.  With ``softcap > 0`` a
    scaled score ``s`` becomes ``softcap * tanh(s / softcap)``, before the
    mask, as in the JAX model.  Dead scores (``causal``: key > query,
    unless key < ``prefix_len``, the prefix-LM mask; ``window > 0``: key
    <= query - window; key >= ``valid_len``) take the finite ``-1e30``."""
    Sq, hd = q.shape[1], q.shape[2]
    Sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * hd ** -0.5
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= (kp <= qp) | (kp < prefix_len)
    if window > 0:
        ok &= kp > qp - window
    if valid_len is not None:
        ok &= kp < valid_len
    s = torch.where(ok[None], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def gqa_attention_ref(q, k, v, *, causal=True, window=0, valid_len=None,
                      softcap=0.0, prefix_len=0):
    """``q``: ``(B, Sq, Hq, hd)``, ``k``/``v``: ``(B, Sk, Hkv, hd)`` →
    ``(B, Sq, Hq, hd)``: query head ``h`` reads KV head ``h // (Hq //
    Hkv)``, as the JAX wrapper's KV-head repeat gives it."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)

    def bh(x, S):
        return x.transpose(1, 2).reshape(B * Hq, S, hd)

    o = attention_ref(bh(q, Sq), bh(k, Sk), bh(v, Sk), valid_len,
                      causal=causal, window=window, softcap=softcap,
                      prefix_len=prefix_len)
    return o.reshape(B, Hq, Sq, hd).transpose(1, 2)
