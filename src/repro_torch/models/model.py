"""Model assembly of the port's LM serving path: ``init``, ``init_cache``,
``prefill`` and ``decode_step`` of the JAX package's ``models/model.py``,
for configurations whose blocks are all causal attention (``"attn"``) with
a SwiGLU MLP: no experts, no encoder or prefix, no score softcap, no QKV
bias, a bf16 or f32 KV cache.  Any other configuration raises
``NotImplementedError``.

Parameters are a dict ``{"embed": {"tok"}, "final_ln": {"scale"},
"layers": [{"mix": ..., "ffn": ...}, ...]}``: one entry per layer, where
the JAX package stacks scanned layers on a leading ``reps`` axis
(:mod:`.convert` carries its pytree across).  The cache is ``{"idx": int,
"layers": [{"k", "v"}, ...]}`` with ``k``/``v`` of shape ``(B, s_cache,
Hkv, hd)``; ``decode_step`` updates it in place and returns it.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.backend import resolve_device
from .config import ModelConfig
from .layers import (UNPORTED, Init, attention_apply, attention_decode,
                     embed_apply, init_attention, init_embedding, init_mlp,
                     init_rms_norm, mlp_apply, rms_norm, unembed_apply)

__all__ = ["Model", "check_supported"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming what of ``cfg`` the port does
    not run yet."""
    missing = []
    kinds = sorted(set(cfg.kinds()) - {"attn"})
    if kinds:
        missing.append(f"block kinds {kinds}")
    if cfg.n_experts:
        missing.append("mixture of experts")
    if cfg.encoder_layers or cfg.family == "audio":
        missing.append("encoder-decoder")
    if cfg.prefix_len or cfg.family == "vlm":
        missing.append("prefix-LM")
    if cfg.logit_softcap > 0.0:
        missing.append("logit softcap")
    if cfg.qkv_bias:
        missing.append("QKV bias")
    if cfg.kv_cache_dtype not in DTYPES:
        missing.append(f"{cfg.kv_cache_dtype} KV cache")
    if not cfg.tied_embeddings:
        missing.append("untied embeddings")
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} {UNPORTED}")


class Model:
    """Dense attention-only LM bound to a config and a device (``"cuda"``,
    the default, or ``"cpu"``; ``"meta"`` builds shapes only)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = (torch.device("meta") if str(device) == "meta"
                       else resolve_device(device))
        self.dtype = DTYPES[cfg.dtype]
        self.kv_dtype = DTYPES[cfg.kv_cache_dtype]

    # ---- init -------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None) -> dict:
        """Random parameters drawn from ``generator`` (on its own device;
        a generator on the card draws there) and written in the compute
        dtype to the model's device; norm scales f32."""
        cfg = self.cfg
        if generator is None and self.device.type != "meta":
            raise ValueError("init needs a torch.Generator")
        init = Init(generator, self.dtype, self.device)
        return {
            "embed": init_embedding(init, cfg),
            "final_ln": init_rms_norm(init, cfg.d_model),
            "layers": [{"mix": init_attention(init, cfg), "ffn": init_mlp(init, cfg)}
                       for _ in range(cfg.num_layers)],
        }

    # ---- serving ------------------------------------------------------------
    def init_cache(self, B: int, s_cache: int) -> dict:
        shape = (B, s_cache, self.cfg.n_kv_heads, self.cfg.hd)

        def zeros():
            return torch.zeros(shape, dtype=self.kv_dtype, device=self.device)

        return {"idx": 0,
                "layers": [{"k": zeros(), "v": zeros()}
                           for _ in range(self.cfg.num_layers)]}

    def prefill(self, params: dict, tokens: torch.Tensor, s_cache: int):
        """Run the prompt ``tokens`` ``(B, S)`` and build the decode cache:
        ``(logits (B, 1, V_pad) of the last position, cache)``.  A prompt
        longer than ``s_cache`` keeps its first ``s_cache`` keys, and
        ``idx`` is ``S`` all the same, as in the JAX package."""
        cfg = self.cfg
        tokens = tokens.to(self.device)
        B, S = tokens.shape
        x = embed_apply(params["embed"], cfg, tokens, self.dtype)
        positions = torch.arange(S, device=self.device).expand(B, S)
        cache = self.init_cache(B, s_cache)
        n = min(S, s_cache)
        for lp, slot in zip(params["layers"], cache["layers"]):
            x, (k, v) = attention_apply(lp["mix"], cfg, x, positions, return_kv=True)
            slot["k"][:, :n] = k[:, :n].to(self.kv_dtype)
            slot["v"][:, :n] = v[:, :n].to(self.kv_dtype)
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
        for lp, slot in zip(params["layers"], cache["layers"]):
            x, _ = attention_decode(lp["mix"], cfg, x, slot, idx)
            x = mlp_apply(lp["ffn"], x)
        x = rms_norm(params["final_ln"], x)
        cache["idx"] = idx + 1
        return unembed_apply(params["embed"], cfg, x), cache
