"""Model assembly of the port's LM serving path: ``init``, ``init_cache``,
``prefill`` and ``decode_step`` of the JAX package's ``models/model.py``,
for configurations whose blocks are causal attention (``"attn"``),
sliding-window attention (``"attn_local"``) or the RG-LRU recurrence
(``"rec"``), each with its SwiGLU MLP or, with ``n_experts``, its mixture of
experts (:mod:`.moe`), or the xLSTM blocks (``"mlstm"``, ``"slstm"``,
which carry their own projections): granite, gemma3, qwen1.5,
RecurrentGemma, llama4-scout, arctic and xLSTM.  An encoder or a prefix and
untied embeddings raise ``NotImplementedError``.

Parameters are a dict ``{"embed": {"tok"}, "final_ln": {"scale"},
"layers": [{"mix": ..., "ffn": ...}, ...]}``: one entry per layer, where
the JAX package stacks scanned layers on a leading ``reps`` axis
(:mod:`.convert` carries its pytree across).  The cache is ``{"idx": int,
"layers": [...]}`` with one dict per layer: an attention layer's ``k`` /
``v`` ``(B, S, Hkv, hd)``, where ``S`` is ``s_cache`` for a global layer
and ``min(window, s_cache)`` for a local layer's ring, plus ``scale``
``(B, S, Hkv, 2)`` f32 for an int8 cache; a ``rec`` layer's ``h`` ``(B,
R)`` f32 and ``conv`` ``(B, W-1, R)``; an ``mlstm`` layer's ``C`` ``(B, H,
d, d)``, ``n`` ``(B, H, d)``, ``m`` ``(B, H)`` f32 and ``conv`` ``(B, W-1,
2D)``; an ``slstm`` layer's ``c``, ``n``, ``m``, ``h`` ``(B, D)`` f32 and
``conv`` ``(B, W-1, D)``.  Every ``conv`` state is bf16, under f32 compute
too, as in the JAX package.  ``decode_step`` updates the cache in place
and returns it.

``prefill(..., dist=DistContext(mesh))`` runs the MoE blocks on their
expert-parallel path (each rank its batch shard, its MoE layers' slices of
:func:`.moe.shard_moe_params`); decode always runs them locally, as in the
JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..kernels.backend import resolve_device
from .config import ModelConfig
from .layers import (UNPORTED, Init, attention_apply, attention_decode,
                     embed_apply, init_attention, init_embedding, init_mlp,
                     init_rms_norm, mlp_apply, quantize_int8, rms_norm,
                     unembed_apply)
from .moe import init_moe, moe_apply
from .recurrent import (NEG_STATE, init_mlstm_block, init_rglru_block,
                        init_slstm_block, mlstm_block_apply, mlstm_block_decode,
                        rglru_block_apply, rglru_block_decode, slstm_block_apply,
                        slstm_block_decode)

__all__ = ["Model", "DistContext", "check_supported"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
KV_DTYPES = dict(DTYPES, int8=torch.int8)
MASKS = {"attn": "causal", "attn_local": "window"}
MIXERS = {"attn": init_attention, "attn_local": init_attention,
          "rec": init_rglru_block, "mlstm": init_mlstm_block,
          "slstm": init_slstm_block}
BLOCK_KINDS = tuple(MIXERS)
# the recurrent kinds: (prefill with its state, decode step, the state's
# cache leaves but conv)
RECURRENT = {"rec": (rglru_block_apply, rglru_block_decode, ("h",)),
             "mlstm": (mlstm_block_apply, mlstm_block_decode, ("C", "n", "m")),
             "slstm": (slstm_block_apply, slstm_block_decode, ("c", "n", "m", "h"))}


@dataclasses.dataclass(frozen=True)
class DistContext:
    """The mesh that the MoE blocks' expert-parallel path runs on (a
    ``DeviceMesh`` of :mod:`repro_torch.launch.mesh`), its batch axes and
    its expert axis; the JAX package's ``DistContext`` without its
    activation sharding constraint (each rank holds its own batch shard)."""
    mesh: Any = None
    dp_axes: tuple = ("data",)
    ep_axis: str = "model"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming what of ``cfg`` the port does
    not run yet."""
    missing = []
    kinds = sorted(set(cfg.kinds()) - set(BLOCK_KINDS))
    if kinds:
        missing.append(f"block kinds {kinds}")
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
        dtype to the model's device; norm scales, ``lam`` and the sLSTM's
        recurrent matrices f32."""
        cfg = self.cfg
        if generator is None and self.device.type != "meta":
            raise ValueError("init needs a torch.Generator")
        init = Init(generator, self.dtype, self.device)

        def block(kind):
            p = {"mix": MIXERS[kind](init, cfg)}
            if kind.startswith("attn") and cfg.n_experts:
                p["ffn"] = init_moe(init, cfg)
            elif kind in ("attn", "attn_local", "rec") and cfg.d_ff:
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

        def full(shape, value):
            return torch.full(shape, value, dtype=torch.float32, device=self.device)

        def layer(kind):
            W, D = cfg.conv_width, cfg.d_model
            if kind == "rec":
                R = cfg.d_rnn or D
                return {"h": zeros((B, R), torch.float32),
                        "conv": zeros((B, W - 1, R), torch.bfloat16)}
            if kind == "mlstm":
                H = cfg.n_state_heads
                d = 2 * D // H
                return {"C": zeros((B, H, d, d), torch.float32),
                        "n": zeros((B, H, d), torch.float32),
                        "m": full((B, H), NEG_STATE),
                        "conv": zeros((B, W - 1, 2 * D), torch.bfloat16)}
            if kind == "slstm":
                return {"c": zeros((B, D), torch.float32),
                        "n": zeros((B, D), torch.float32),
                        "m": full((B, D), NEG_STATE),
                        "h": zeros((B, D), torch.float32),
                        "conv": zeros((B, W - 1, D), torch.bfloat16)}
            S = min(cfg.window, s_cache) if kind == "attn_local" else s_cache
            shape = (B, S, cfg.n_kv_heads, cfg.hd)
            c = {"k": zeros(shape, self.kv_dtype), "v": zeros(shape, self.kv_dtype)}
            if self.kv_dtype == torch.int8:
                c["scale"] = zeros((B, S, cfg.n_kv_heads, 2), torch.float32)
            return c

        return {"idx": 0, "layers": [layer(kind) for kind in self.kinds]}

    def prefill(self, params: dict, tokens: torch.Tensor, s_cache: int, *,
                dist: Optional[DistContext] = None):
        """Run the prompt ``tokens`` ``(B, S)`` and build the decode cache:
        ``(logits (B, 1, V_pad) of the last position, cache)``.  A prompt
        longer than a global layer's ``s_cache`` keeps its first keys there,
        and the last ones in a local layer's ring; ``idx`` is ``S`` all the
        same, as in the JAX package.  With ``dist`` the MoE blocks run
        expert parallel: ``tokens`` is this rank's batch shard and each MoE
        layer's ``ffn`` this rank's slices."""
        cfg = self.cfg
        tokens = tokens.to(self.device)
        B, S = tokens.shape
        x = embed_apply(params["embed"], cfg, tokens, self.dtype)
        positions = torch.arange(S, device=self.device).expand(B, S)
        cache = self.init_cache(B, s_cache)
        for kind, lp, slot in zip(self.kinds, params["layers"], cache["layers"]):
            if kind in RECURRENT:
                x, state = RECURRENT[kind][0](lp["mix"], cfg, x, return_state=True)
                _fill_state(slot, kind, state)
            else:
                x, kv = attention_apply(lp["mix"], cfg, x, positions,
                                        kind=MASKS[kind], return_kv=True)
                _fill_kv(slot, kind, *kv)
            if "ffn" in lp:
                x = self._ffn(lp["ffn"], x, dist)
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
            if kind in RECURRENT:
                x = RECURRENT[kind][1](lp["mix"], cfg, x, slot)
            else:
                x, _ = attention_decode(lp["mix"], cfg, x, slot, idx,
                                        local=kind == "attn_local")
            if "ffn" in lp:
                x = self._ffn(lp["ffn"], x, None)
        x = rms_norm(params["final_ln"], x)
        cache["idx"] = idx + 1
        return unembed_apply(params["embed"], cfg, x), cache

    def _ffn(self, p: dict, x: torch.Tensor, dist: Optional[DistContext]):
        """An attention or RG-LRU layer's MLP, or an attention layer's
        experts (expert parallel on ``dist``'s mesh, locally without one)."""
        if "router" not in p:
            return mlp_apply(p, x)
        if dist is None:
            return moe_apply(p, self.cfg, x)[0]
        return moe_apply(p, self.cfg, x, mesh=dist.mesh, dp_axes=dist.dp_axes,
                         ep_axis=dist.ep_axis)[0]


def _fill_state(slot: dict, kind: str, state) -> None:
    """Write a recurrent layer's state after the prompt into its cache
    slot (the conv state rounded to the cache's bf16)."""
    inner, conv = state
    for name, t in zip(RECURRENT[kind][2], (inner,) if kind == "rec" else inner):
        slot[name].copy_(t)
    slot["conv"].copy_(conv)


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
