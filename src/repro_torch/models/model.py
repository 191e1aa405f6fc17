"""Model assembly of the port's LM serving path: ``init``, ``init_cache``,
``prefill`` and ``decode_step`` of the JAX package's ``models/model.py``,
for configurations whose blocks are causal attention (``"attn"``),
sliding-window attention (``"attn_local"``) or the RG-LRU recurrence
(``"rec"``), each with its SwiGLU MLP: granite, gemma3, qwen1.5 and
RecurrentGemma.  Experts, an encoder or a prefix, the xLSTM blocks and
untied embeddings raise ``NotImplementedError``.

Parameters are a dict ``{"embed": {"tok"}, "final_ln": {"scale"},
"layers": [{"mix": ..., "ffn": ...}, ...]}``: one entry per layer, where
the JAX package stacks scanned layers on a leading ``reps`` axis
(:mod:`.convert` carries its pytree across).  The cache is ``{"idx": int,
"layers": [...]}`` with one dict per layer: an attention layer's ``k`` /
``v`` ``(B, S, Hkv, hd)``, where ``S`` is ``s_cache`` for a global layer
and ``min(window, s_cache)`` for a local layer's ring, plus ``scale``
``(B, S, Hkv, 2)`` f32 for an int8 cache; a ``rec`` layer's ``h`` ``(B,
R)`` f32 and ``conv`` ``(B, W-1, R)`` bf16 (bf16 under f32 compute too, as
in the JAX package).  ``decode_step`` updates it in place and returns it.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.backend import resolve_device
from .config import ModelConfig
from .layers import (UNPORTED, Init, attention_apply, attention_decode,
                     embed_apply, init_attention, init_embedding, init_mlp,
                     init_rms_norm, mlp_apply, quantize_int8, rms_norm,
                     unembed_apply)
from .recurrent import init_rglru_block, rglru_block_apply, rglru_block_decode

__all__ = ["Model", "check_supported"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
KV_DTYPES = dict(DTYPES, int8=torch.int8)
BLOCK_KINDS = ("attn", "attn_local", "rec")
MASKS = {"attn": "causal", "attn_local": "window"}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming what of ``cfg`` the port does
    not run yet."""
    missing = []
    kinds = sorted(set(cfg.kinds()) - set(BLOCK_KINDS))
    if kinds:
        missing.append(f"block kinds {kinds}")
    if cfg.n_experts:
        missing.append("mixture of experts")
    if cfg.encoder_layers or cfg.family == "audio":
        missing.append("encoder-decoder")
    if cfg.prefix_len or cfg.family == "vlm":
        missing.append("prefix-LM")
    if cfg.kv_cache_dtype not in KV_DTYPES:
        missing.append(f"{cfg.kv_cache_dtype} KV cache")
    if not cfg.tied_embeddings:
        missing.append("untied embeddings")
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} {UNPORTED}")


class Model:
    """The LM bound to a config and a device (``"cuda"``, the default, or
    ``"cpu"``; ``"meta"`` builds shapes only)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.kinds = cfg.kinds()
        self.device = (torch.device("meta") if str(device) == "meta"
                       else resolve_device(device))
        self.dtype = DTYPES[cfg.dtype]
        self.kv_dtype = KV_DTYPES[cfg.kv_cache_dtype]

    # ---- init -------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None) -> dict:
        """Random parameters drawn from ``generator`` (on its own device;
        a generator on the card draws there) and written in the compute
        dtype to the model's device; norm scales and ``lam`` f32."""
        cfg = self.cfg
        if generator is None and self.device.type != "meta":
            raise ValueError("init needs a torch.Generator")
        init = Init(generator, self.dtype, self.device)

        def block(kind):
            mix = init_rglru_block if kind == "rec" else init_attention
            p = {"mix": mix(init, cfg)}
            if cfg.d_ff:
                p["ffn"] = init_mlp(init, cfg)
            return p

        return {
            "embed": init_embedding(init, cfg),
            "final_ln": init_rms_norm(init, cfg.d_model),
            "layers": [block(kind) for kind in self.kinds],
        }

    # ---- serving ------------------------------------------------------------
    def init_cache(self, B: int, s_cache: int) -> dict:
        cfg = self.cfg

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        def layer(kind):
            if kind == "rec":
                R = cfg.d_rnn or cfg.d_model
                return {"h": zeros((B, R), torch.float32),
                        "conv": zeros((B, cfg.conv_width - 1, R), torch.bfloat16)}
            S = min(cfg.window, s_cache) if kind == "attn_local" else s_cache
            shape = (B, S, cfg.n_kv_heads, cfg.hd)
            c = {"k": zeros(shape, self.kv_dtype), "v": zeros(shape, self.kv_dtype)}
            if self.kv_dtype == torch.int8:
                c["scale"] = zeros((B, S, cfg.n_kv_heads, 2), torch.float32)
            return c

        return {"idx": 0, "layers": [layer(kind) for kind in self.kinds]}

    def prefill(self, params: dict, tokens: torch.Tensor, s_cache: int):
        """Run the prompt ``tokens`` ``(B, S)`` and build the decode cache:
        ``(logits (B, 1, V_pad) of the last position, cache)``.  A prompt
        longer than a global layer's ``s_cache`` keeps its first keys there,
        and the last ones in a local layer's ring; ``idx`` is ``S`` all the
        same, as in the JAX package."""
        cfg = self.cfg
        tokens = tokens.to(self.device)
        B, S = tokens.shape
        x = embed_apply(params["embed"], cfg, tokens, self.dtype)
        positions = torch.arange(S, device=self.device).expand(B, S)
        cache = self.init_cache(B, s_cache)
        for kind, lp, slot in zip(self.kinds, params["layers"], cache["layers"]):
            if kind == "rec":
                x, (h, conv) = rglru_block_apply(lp["mix"], cfg, x, return_state=True)
                slot["h"].copy_(h)
                slot["conv"].copy_(conv)
            else:
                x, kv = attention_apply(lp["mix"], cfg, x, positions,
                                        kind=MASKS[kind], return_kv=True)
                _fill_kv(slot, kind, *kv)
            if "ffn" in lp:
                x = mlp_apply(lp["ffn"], x)
        x = rms_norm(params["final_ln"], x)
        cache["idx"] = S
        return unembed_apply(params["embed"], cfg, x[:, -1:]), cache

    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict):
        """tokens ``(B, 1)`` → ``(logits (B, 1, V_pad), cache)``, every slot
        at the shared position ``cache["idx"]``."""
        cfg = self.cfg
        idx = cache["idx"]
        x = embed_apply(params["embed"], cfg, tokens.to(self.device), self.dtype)
        for kind, lp, slot in zip(self.kinds, params["layers"], cache["layers"]):
            if kind == "rec":
                x = rglru_block_decode(lp["mix"], cfg, x, slot)
            else:
                x, _ = attention_decode(lp["mix"], cfg, x, slot, idx,
                                        local=kind == "attn_local")
            if "ffn" in lp:
                x = mlp_apply(lp["ffn"], x)
        x = rms_norm(params["final_ln"], x)
        cache["idx"] = idx + 1
        return unembed_apply(params["embed"], cfg, x), cache


def _fill_kv(slot: dict, kind: str, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write a prompt's keys and values ``(B, S, Hkv, hd)`` into an
    attention layer's cache of ``Sc`` slots: a global layer the first
    ``min(S, Sc)`` at their positions, a local layer whose prompt is longer
    than its ring the last ``Sc`` at ``position % Sc``; an int8 cache
    quantized, with its scales."""
    S, Sc = k.shape[1], slot["k"].shape[1]
    lo = S - Sc if kind == "attn_local" and S > Sc else 0
    sel = torch.arange(lo, min(S, lo + Sc), device=k.device)
    wslot = sel % Sc
    ks, vs = k[:, sel], v[:, sel]
    if "scale" in slot:
        (kq, ksc), (vq, vsc) = quantize_int8(ks), quantize_int8(vs)
        slot["k"][:, wslot] = kq
        slot["v"][:, wslot] = vq
        slot["scale"][:, wslot] = torch.stack([ksc, vsc], -1)
    else:
        slot["k"][:, wslot] = ks.to(slot["k"].dtype)
        slot["v"][:, wslot] = vs.to(slot["v"].dtype)
