"""Layer library of the port's LM serving path: the parts of the JAX
package's ``models/layers.py`` that the ported families run (causal and
sliding-window attention with an optional score softcap, QKV bias and an
int8 KV cache, the SwiGLU MLP, the tied embedding), in torch.  The
experts are in :mod:`.moe`, the recurrent blocks in :mod:`.recurrent`.

Parameters are plain dicts of tensors with the JAX names.  Weights are held
in the compute dtype (bf16 on the card) and norm scales in f32; the casts
sit where the JAX package puts them, so that bf16 runs round at the same
points: ``embed_apply`` casts the table and multiplies by ``sqrt(D)`` in
the compute dtype, ``dense`` casts the weight to ``x``'s dtype,
``rms_norm`` / ``apply_rope`` / attention compute in f32 and cast back.
Prefill attention runs on the flash-attention kernel
(:mod:`repro_torch.kernels.flash_attn`); decode attention, a product over
the cache, and the large products are torch ops (``torch.matmul``), as the
JAX package leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_attn.ops import flash_attention_kernel
from ..kernels.flash_attn.ref import NEG_INF
from .config import ModelConfig

__all__ = [
    "RopeSpec", "rms_norm", "init_rms_norm", "init_dense", "dense",
    "apply_rope", "flash_attention", "decode_attention",
    "init_attention", "attention_apply", "attention_decode",
    "init_mlp", "mlp_apply", "init_embedding", "embed_apply", "unembed_apply",
    "softcap", "quantize_int8",
]

UNPORTED = "not ported yet (ROADMAP A12)"


class Init:
    """Draws the random weights of one model: normal values from
    ``generator`` (on its own device), scaled in f32, then cast to
    ``dtype`` and moved to ``device``.  On the ``meta`` device it makes
    shapes only."""

    def __init__(self, generator: Optional[torch.Generator], dtype: torch.dtype,
                 device: torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = device

    def normal(self, shape, std: float,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Normal values of ``std`` in ``dtype`` (the compute dtype by
        default)."""
        dtype = dtype or self.dtype
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device="meta")
        g = self.generator
        w = torch.randn(shape, generator=g, device=g.device, dtype=torch.float32)
        return w.mul_(std).to(self.device, dtype)

    def stacked(self, n: int, shape, std: float) -> torch.Tensor:
        """``n`` slices of :meth:`normal` ``(n, *shape)``, drawn one slice at
        a time, so that the f32 draw holds one slice (an expert stack of
        arctic is 17.9 GB in f32, 8.9 GB in bf16)."""
        if self.device.type == "meta":
            return self.normal((n, *shape), std)
        out = torch.empty((n, *shape), dtype=self.dtype, device=self.device)
        for i in range(n):
            out[i] = self.normal(shape, std)
        return out

    def zeros(self, shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)


# --------------------------------------------------------------------------
# Primitives
# --------------------------------------------------------------------------

def init_rms_norm(init: Init, d: int) -> dict:
    return {"scale": init.zeros((d,))}


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + params["scale"])).to(x.dtype)


def init_dense(init: Init, d_in: int, d_out, *, bias: bool = False,
               scale: float | None = None) -> dict:
    """A weight ``(d_in, *d_out)``; with ``bias`` a zero ``b`` of shape
    ``d_out`` in the compute dtype."""
    shape = (d_in,) + (tuple(d_out) if isinstance(d_out, (tuple, list)) else (d_out,))
    p = {"w": init.normal(shape, scale if scale is not None else d_in ** -0.5)}
    if bias:
        p["b"] = init.zeros(shape[1:], init.dtype)
    return p


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Contract ``x``'s last axis with the weight's first: ``(D, H, hd)``
    weights give ``(..., H, hd)``, ``(H * hd, D)`` weights ``(..., D)``;
    then add ``b``, cast to ``x``'s dtype, where the layer has one."""
    w = params["w"].to(x.dtype)
    y = torch.matmul(x, w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RopeSpec:
    dim: int
    theta: float = 10_000.0


def _rope_angles(positions: torch.Tensor, spec: RopeSpec):
    half = spec.dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freq = torch.pow(torch.tensor(spec.theta, dtype=torch.float32,
                                  device=positions.device), exps)
    ang = positions.float()[..., None] * freq                  # (..., half)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, spec: RopeSpec) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S)."""
    sin, cos = _rope_angles(positions, spec)
    sin, cos = sin[..., None, :], cos[..., None, :]            # over heads
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kind: str = "causal", window: int = 0,
                    softcap_val: float = 0.0) -> torch.Tensor:
    """``q``: ``(B, Sq, Hq, hd)``, ``k``/``v``: ``(B, Sk, Hkv, hd)`` on the
    flash-attention kernel; ``kind`` ``"causal"`` or ``"window"`` (causal
    sliding window of ``window`` keys); ``softcap_val > 0`` caps the
    scaled scores before the mask."""
    if kind in ("causal", "window"):
        return flash_attention_kernel(q, k, v, causal=True,
                                      window=window if kind == "window" else 0,
                                      softcap=softcap_val)
    if kind in ("full", "prefix"):
        raise NotImplementedError(f"attention kind {kind!r} {UNPORTED}: "
                                  "whisper, paligemma")
    raise ValueError(kind)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_index: int, *,
                     softcap_val: float = 0.0,
                     kv_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One query token ``(B, 1, Hq, hd)`` against the first ``cur_index``
    entries of a ``(B, S, Hkv, hd)`` cache; f32 math, ``q``'s dtype out.
    An int8 cache is dequantized with ``kv_scale`` ``(B, S, Hkv, 2)`` (the
    keys' scale, then the values')."""
    B, S, Hkv, hd = k_cache.shape
    kf, vf = k_cache.float(), v_cache.float()
    if kv_scale is not None:
        kf = kf * kv_scale[..., 0, None]
        vf = vf * kv_scale[..., 1, None]
    g = q.shape[2] // Hkv
    qf = q.reshape(B, Hkv, g, hd).float()
    s = torch.einsum("bhgd,bshd->bhgs", qf, kf) * hd ** -0.5
    s = softcap(s, softcap_val)
    pos = torch.arange(S, device=q.device)
    s = torch.where(pos < cur_index, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, vf)
    return o.reshape(B, 1, Hkv * g, hd).to(q.dtype)


def quantize_int8(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(..., hd)`` → int8 values and an f32 scale per ``(...)``:
    ``max(amax, 1e-6) / 127``, rounded half to even as ``jnp.round``."""
    tf = t.float()
    scale = tf.abs().amax(-1).clamp_min(1e-6) / 127.0
    return torch.round(tf / scale[..., None]).to(torch.int8), scale


def init_attention(init: Init, cfg: ModelConfig) -> dict:
    D, hd = cfg.d_model, cfg.hd
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "ln": init_rms_norm(init, D),
        "q": init_dense(init, D, (Hq, hd), bias=cfg.qkv_bias),
        "k": init_dense(init, D, (Hkv, hd), bias=cfg.qkv_bias),
        "v": init_dense(init, D, (Hkv, hd), bias=cfg.qkv_bias),
        "o": init_dense(init, Hq * hd, D, scale=(Hq * hd) ** -0.5),
    }


def attention_apply(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, kind: str = "causal",
                    return_kv: bool = False):
    """Pre-norm GQA self-attention block with RoPE and its residual, the
    mask ``kind`` ``"causal"`` or ``"window"`` (``cfg.window`` keys):
    ``x`` ``(B, S, D)`` → ``(B, S, D)``; with ``return_kv`` also the
    block's ``(k, v)`` (``k`` after RoPE), which prefill writes to the
    cache."""
    h = rms_norm(params["ln"], x)
    q, k, v = dense(params["q"], h), dense(params["k"], h), dense(params["v"], h)
    spec = RopeSpec(cfg.hd, cfg.rope_theta)
    q = apply_rope(q, positions, spec)
    k = apply_rope(k, positions, spec)
    o = flash_attention(q, k, v, kind=kind, window=cfg.window,
                        softcap_val=cfg.logit_softcap)
    B, S = x.shape[:2]
    out = x + dense(params["o"], o.reshape(B, S, cfg.n_heads * cfg.hd))
    return (out, (k, v)) if return_kv else out


def attention_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: dict, idx: int, *,
                     local: bool = False) -> tuple[torch.Tensor, dict]:
    """One decode step ``x`` ``(B, 1, D)`` at position ``idx``: writes this
    token's K/V into ``cache`` (in place) and attends over it.  A global
    layer writes slot ``idx``, clamped to the cache's last slot as the JAX
    package's ``dynamic_update_slice`` clamps it, and attends over entries
    ``< idx + 1``; a ``local`` layer's cache is a ring: it writes slot
    ``idx % S`` and attends over ``min(idx + 1, S)`` slots.  A cache with a
    ``scale`` leaf is int8: the token's K/V are quantized per head."""
    h = rms_norm(params["ln"], x)
    q, k, v = dense(params["q"], h), dense(params["k"], h), dense(params["v"], h)
    spec = RopeSpec(cfg.hd, cfg.rope_theta)
    pos = torch.full((x.shape[0], 1), idx, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, spec)
    k = apply_rope(k, pos, spec)
    S = cache["k"].shape[1]
    if local:
        slot, cur = idx % S, min(idx + 1, S)
    else:
        slot, cur = min(max(idx, 0), S - 1), idx + 1
    if "scale" in cache:
        (kq, ksc), (vq, vsc) = quantize_int8(k[:, 0]), quantize_int8(v[:, 0])
        cache["k"][:, slot] = kq
        cache["v"][:, slot] = vq
        cache["scale"][:, slot] = torch.stack([ksc, vsc], -1)
    else:
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    o = decode_attention(q, cache["k"], cache["v"], cur,
                         softcap_val=cfg.logit_softcap,
                         kv_scale=cache.get("scale"))
    B = x.shape[0]
    return x + dense(params["o"], o.reshape(B, 1, cfg.n_heads * cfg.hd)), cache


# --------------------------------------------------------------------------
# MLP (SwiGLU)
# --------------------------------------------------------------------------

def init_mlp(init: Init, cfg: ModelConfig) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "ln": init_rms_norm(init, D),
        "wi": init_dense(init, D, Fd),
        "wg": init_dense(init, D, Fd),
        "wo": init_dense(init, Fd, D, scale=Fd ** -0.5),
    }


def mlp_apply(params: dict, x: torch.Tensor, *, residual: bool = True) -> torch.Tensor:
    """The pre-norm SwiGLU MLP, plus ``x`` with ``residual`` (the MoE's
    shared expert and dense MLP add their output themselves)."""
    h = rms_norm(params["ln"], x)
    y = dense(params["wo"], F.silu(dense(params["wg"], h)) * dense(params["wi"], h))
    return x + y if residual else y


# --------------------------------------------------------------------------
# Embedding / unembedding (tied, vocab padded to ``vocab_pad``)
# --------------------------------------------------------------------------

def init_embedding(init: Init, cfg: ModelConfig) -> dict:
    return {"tok": init.normal((cfg.vocab_pad, cfg.d_model), 1.0)}


def embed_apply(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    e = params["tok"].to(dtype)[tokens.long()]
    return e * torch.tensor(cfg.d_model ** 0.5, dtype=dtype, device=e.device)


def unembed_apply(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(x, params["tok"].to(x.dtype).t())
    return softcap(logits, cfg.logit_softcap)
