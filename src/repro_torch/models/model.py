"""Model assembly of the port's LM serving path: ``init``, ``init_cache``,
``prefill`` and ``decode_step`` of the JAX package's ``models/model.py``,
for configurations whose blocks are causal attention (``"attn"``; a
prefix-LM mask over the patches for the ``"vlm"`` family),
sliding-window attention (``"attn_local"``) or the RG-LRU recurrence
(``"rec"``), each with its SwiGLU MLP or, with ``n_experts``, its mixture of
experts (:mod:`.moe`), or the xLSTM blocks (``"mlstm"``, ``"slstm"``,
which carry their own projections): granite, gemma3, qwen1.5,
RecurrentGemma, llama4-scout, arctic, xLSTM, whisper (the ``"audio"``
family: an encoder of ``encoder_layers`` full-attention blocks over
precomputed frame embeddings ``enc_embed``, sinusoidal positions and no
RoPE, cross-attention in every decoder block) and paligemma (the
``"vlm"`` family: ``prefix_len`` precomputed patch embeddings
``patches``, projected and put before the text).  Tied or untied
embeddings.

Parameters are a dict ``{"embed": {"tok"[, "out"]}, "final_ln":
{"scale"}, "layers": [{"mix": ..., "ffn": ...[, "xattn": ...]}, ...]}``,
plus ``"encoder": {"layers": [...], "ln"}`` for audio and
``"patch_proj": {"w"}`` for vlm: one entry per layer, where
the JAX package stacks scanned layers on a leading ``reps`` axis
(:mod:`.convert` carries its pytree across).  The cache is ``{"idx": int,
"layers": [...]}`` (plus ``"enc_out"`` ``(B, Se, D)``, the encoder's
output, for audio) with one dict per layer: an attention layer's ``k`` /
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

``forward(params, batch)`` is the training forward, ``(logits, aux)`` over
the whole sequence, differentiable by autograd (the flash kernel through
:class:`repro_torch.kernels.flash_attn.ops.FlashAttention`); with
``remat`` (the default, as the JAX package's) each layer runs under
``torch.utils.checkpoint``, so its activations are recomputed in the
backward pass, as ``jax.checkpoint`` does.  ``init(..., masters=True)``
draws every leaf in f32, the JAX package's master weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.backend import resolve_device
from .config import ModelConfig
from .layers import (UNPORTED, Init, attention_apply, attention_decode, dense,
                     embed_apply, init_attention, init_dense, init_embedding,
                     init_mlp, init_rms_norm, mlp_apply, quantize_int8,
                     rms_norm, sinusoidal_positions, unembed_apply)
from .moe import init_moe, moe_apply
from .recurrent import (NEG_STATE, init_mlstm_block, init_rglru_block,
                        init_slstm_block, mlstm_block_apply, mlstm_block_decode,
                        rglru_block_apply, rglru_block_decode, slstm_block_apply,
                        slstm_block_decode)

__all__ = ["Model", "DistContext", "check_supported"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
KV_DTYPES = dict(DTYPES, int8=torch.int8)
# the modality stub each family's prefill takes (the JAX batch's field)
STUBS = {"audio": "enc_embed", "vlm": "patches"}
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
    not run yet: a decoder block kind outside ``BLOCK_KINDS`` or a KV cache
    dtype outside ``KV_DTYPES``."""
    missing = []
    kinds = sorted(set(cfg.kinds()) - set(BLOCK_KINDS))
    if kinds:
        missing.append(f"block kinds {kinds}")
    if cfg.kv_cache_dtype not in KV_DTYPES:
        missing.append(f"{cfg.kv_cache_dtype} KV cache")
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} {UNPORTED}")


def _mask_kind(cfg: ModelConfig, kind: str) -> tuple[str, int]:
    """The attention mask of a decoder block ``kind`` and its prefix
    length: a local layer a window, a vlm's attention layer the prefix-LM
    mask over its patches (whisper's encoder runs ``"full"``)."""
    if kind == "attn_local":
        return "window", 0
    if cfg.family == "vlm" and cfg.prefix_len:
        return "prefix", cfg.prefix_len
    return "causal", 0


class Model:
    """The LM bound to a config and a device (``"cuda"``, the default, or
    ``"cpu"``; ``"meta"`` builds shapes only).  ``stub`` names the modality
    input that ``prefill`` needs (``"enc_embed"``, ``"patches"`` or
    None)."""

    def __init__(self, cfg: ModelConfig, *, remat: bool = True, device="cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.remat = remat
        self.kinds = cfg.kinds()
        self.use_rope = cfg.family != "audio"
        self.cross = cfg.family == "audio"          # whisper's decoder blocks
        self.stub = STUBS.get(cfg.family)
        self.device = (torch.device("meta") if str(device) == "meta"
                       else resolve_device(device))
        self.dtype = DTYPES[cfg.dtype]
        self.kv_dtype = KV_DTYPES[cfg.kv_cache_dtype]

    # ---- init -------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None, *,
             masters: bool = False) -> dict:
        """Random parameters drawn from ``generator`` (on its own device;
        a generator on the card draws there) and written in the compute
        dtype to the model's device; norm scales, ``lam`` and the sLSTM's
        recurrent matrices f32.  With ``masters`` every leaf is f32, as the
        JAX package's master weights (the trainer's)."""
        cfg = self.cfg
        if generator is None and self.device.type != "meta":
            raise ValueError("init needs a torch.Generator")
        init = Init(generator, torch.float32 if masters else self.dtype, self.device)

        def block(kind):
            p = {"mix": MIXERS[kind](init, cfg)}
            if kind.startswith("attn") and cfg.n_experts:
                p["ffn"] = init_moe(init, cfg)
            elif kind in ("attn", "attn_local", "rec") and cfg.d_ff:
                p["ffn"] = init_mlp(init, cfg)
            if self.cross:
                p["xattn"] = init_attention(init, cfg, cross=True)
            return p

        params = {
            "embed": init_embedding(init, cfg),
            "final_ln": init_rms_norm(init, cfg.d_model),
            "layers": [block(kind) for kind in self.kinds],
        }
        if cfg.family == "audio":
            params["encoder"] = {
                "layers": [{"mix": init_attention(init, cfg), "ffn": init_mlp(init, cfg)}
                           for _ in range(cfg.encoder_layers)],
                "ln": init_rms_norm(init, cfg.d_model)}
        if cfg.family == "vlm":
            # the frontend stub: a projection of precomputed patch embeddings
            params["patch_proj"] = init_dense(init, cfg.d_model, cfg.d_model)
        return params

    # ---- training forward ---------------------------------------------------
    def forward(self, params: dict, batch: dict, *,
                dist: Optional[DistContext] = None):
        """The JAX ``forward``: ``batch`` ``{"tokens": (B, S)[, "enc_embed":
        (B, Se, D) | "patches": (B, prefix_len, D)]}`` (tensors or numpy
        arrays; other keys, such as ``labels``, are ignored) → ``(logits
        (B, S, V_pad), aux)``, ``aux`` the sum of the MoE layers' auxiliary
        losses (0 without experts).  A vlm's logits are those of the text
        positions only.  With ``remat`` each layer is recomputed in the
        backward pass."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"]).to(self.device)
        stubs = {name: torch.as_tensor(batch[name])
                 if name == self.stub and name in batch else None
                 for name in ("enc_embed", "patches")}
        self._check_stub(tokens.shape[0], **stubs)
        x, positions, enc_out = self._embed_inputs(params, tokens, **stubs)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for kind, lp in zip(self.kinds, params["layers"]):
            if self.remat:
                x, a = checkpoint(self._layer, kind, lp, x, positions, enc_out,
                                  dist, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = self._layer(kind, lp, x, positions, enc_out, dist)
            aux = aux + a
        x = rms_norm(params["final_ln"], x)
        if cfg.family == "vlm":
            x = x[:, cfg.prefix_len:]       # the loss is on the text positions
        return unembed_apply(params["embed"], cfg, x), aux

    def _layer(self, kind: str, lp: dict, x: torch.Tensor, positions, enc_out,
               dist: Optional[DistContext]):
        """One decoder layer of the forward, without a cache: ``(x, aux)``."""
        cfg = self.cfg
        if kind in RECURRENT:
            x = RECURRENT[kind][0](lp["mix"], cfg, x)
        else:
            mk, plen = _mask_kind(cfg, kind)
            x = attention_apply(lp["mix"], cfg, x, positions, kind=mk,
                                rope=self.use_rope, prefix_len=plen)
            if "xattn" in lp:
                x = attention_apply(lp["xattn"], cfg, x, positions, kind="full",
                                    kv_src=enc_out, rope=False)
        if "ffn" in lp:
            return self._ffn(lp["ffn"], x, dist)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

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

        cache = {"idx": 0, "layers": [layer(kind) for kind in self.kinds]}
        if cfg.family == "audio":       # set by prefill, as in the JAX package
            cache["enc_out"] = zeros((B, 1, cfg.d_model), self.dtype)
        return cache

    def _check_stub(self, B: int, enc_embed, patches) -> None:
        """Raise ``ValueError`` unless exactly the family's stub is given,
        ``(B, Se, D)`` frames for audio, ``(B, prefix_len, D)`` patches for
        vlm."""
        cfg = self.cfg
        for name, val in (("enc_embed", enc_embed), ("patches", patches)):
            if (val is None) == (name == self.stub):
                raise ValueError(f"{cfg.name} ({cfg.family}) prefill "
                                 f"{'needs' if val is None else 'takes no'} {name}")
        if self.stub is None:
            return
        val = enc_embed if self.stub == "enc_embed" else patches
        S = val.shape[1] if val.dim() == 3 else -1
        if (val.dim() != 3 or val.shape[0] != B or val.shape[2] != cfg.d_model
                or S < 1 or (self.stub == "patches" and S != cfg.prefix_len)):
            want = "Se" if self.stub == "enc_embed" else cfg.prefix_len
            raise ValueError(f"{self.stub} {tuple(val.shape)}: expected "
                             f"({B}, {want}, {cfg.d_model})")

    def _encode(self, params: dict, enc_embed: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder over precomputed frame embeddings ``(B, Se,
        D)``: sinusoidal positions, full attention without RoPE and the MLP
        in every block, then the encoder's norm."""
        cfg = self.cfg
        B, Se = enc_embed.shape[:2]
        pos = sinusoidal_positions(Se, cfg.d_model).to(self.device, self.dtype)
        x = enc_embed.to(self.device, self.dtype) + pos[None]
        positions = torch.arange(Se, device=self.device).expand(B, Se)
        for lp in params["encoder"]["layers"]:
            x = attention_apply(lp["mix"], cfg, x, positions, kind="full", rope=False)
            x = mlp_apply(lp["ffn"], x)
        return rms_norm(params["encoder"]["ln"], x)

    def _embed_inputs(self, params: dict, tokens: torch.Tensor, enc_embed,
                      patches):
        """tokens (and the family's stub) → ``(x, positions, enc_out)``: for
        audio the decoder's sinusoidal positions and the encoder's output,
        for vlm the projected patches before the text."""
        cfg = self.cfg
        x = embed_apply(params["embed"], cfg, tokens, self.dtype)
        enc_out = None
        if cfg.family == "audio":
            enc_out = self._encode(params, enc_embed)
            pos = sinusoidal_positions(tokens.shape[1], cfg.d_model)
            x = x + pos.to(self.device, self.dtype)[None]
        if cfg.family == "vlm":
            proj = dense(params["patch_proj"], patches.to(self.device, self.dtype))
            x = torch.cat([proj, x], dim=1)
        B, S = x.shape[:2]
        return x, torch.arange(S, device=self.device).expand(B, S), enc_out

    def prefill(self, params: dict, tokens: torch.Tensor, s_cache: int, *,
                enc_embed: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None,
                dist: Optional[DistContext] = None):
        """Run the prompt ``tokens`` ``(B, T)`` and build the decode cache:
        ``(logits (B, 1, V_pad) of the last position, cache)``.  Whisper
        needs ``enc_embed`` ``(B, Se, D)`` and keeps its encoder's output in
        ``cache["enc_out"]``; paligemma needs ``patches`` ``(B, prefix_len,
        D)``, which go before the text, so the sequence is ``S = prefix_len
        + T`` long; any other stub, or a missing one, raises
        ``ValueError``.  A sequence longer than a global layer's
        ``s_cache`` keeps its first keys there, and the last ones in a local
        layer's ring; ``idx`` is ``S`` all the same, as in the JAX package.
        With ``dist`` the MoE blocks run expert parallel: ``tokens`` is this
        rank's batch shard and each MoE layer's ``ffn`` this rank's
        slices."""
        cfg = self.cfg
        tokens = tokens.to(self.device)
        self._check_stub(tokens.shape[0], enc_embed, patches)
        x, positions, enc_out = self._embed_inputs(params, tokens, enc_embed, patches)
        B, S = x.shape[:2]
        cache = self.init_cache(B, s_cache)
        if enc_out is not None:
            cache["enc_out"] = enc_out
        for kind, lp, slot in zip(self.kinds, params["layers"], cache["layers"]):
            if kind in RECURRENT:
                x, state = RECURRENT[kind][0](lp["mix"], cfg, x, return_state=True)
                _fill_state(slot, kind, state)
            else:
                mk, plen = _mask_kind(cfg, kind)
                x, kv = attention_apply(lp["mix"], cfg, x, positions, kind=mk,
                                        rope=self.use_rope, prefix_len=plen,
                                        return_kv=True)
                _fill_kv(slot, kind, *kv)
                if "xattn" in lp:
                    x = attention_apply(lp["xattn"], cfg, x, positions, kind="full",
                                        kv_src=enc_out, rope=False)
            if "ffn" in lp:
                x = self._ffn(lp["ffn"], x, dist)[0]
        x = rms_norm(params["final_ln"], x)
        cache["idx"] = S
        return unembed_apply(params["embed"], cfg, x[:, -1:]), cache

    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict):
        """tokens ``(B, 1)`` → ``(logits (B, 1, V_pad), cache)``, every slot
        at the shared position ``cache["idx"]``.  Whisper's token takes the
        sinusoidal position ``cache["idx"]`` (the JAX package adds position
        0's: ROADMAP C-ref 11) and its cross-attention reads
        ``cache["enc_out"]``."""
        cfg = self.cfg
        idx = cache["idx"]
        x = embed_apply(params["embed"], cfg, tokens.to(self.device), self.dtype)
        if cfg.family == "audio":
            pos = sinusoidal_positions(1, cfg.d_model, idx)
            x = x + pos.to(self.device, self.dtype)[None]
        enc_out = cache.get("enc_out")
        for kind, lp, slot in zip(self.kinds, params["layers"], cache["layers"]):
            if kind in RECURRENT:
                x = RECURRENT[kind][1](lp["mix"], cfg, x, slot)
            else:
                x, _ = attention_decode(lp["mix"], cfg, x, slot, idx,
                                        local=kind == "attn_local",
                                        rope=self.use_rope)
                if "xattn" in lp:
                    x, _ = attention_decode(lp["xattn"], cfg, x, {}, idx,
                                            enc_out=enc_out)
            if "ffn" in lp:
                x = self._ffn(lp["ffn"], x, None)[0]
        x = rms_norm(params["final_ln"], x)
        cache["idx"] = idx + 1
        return unembed_apply(params["embed"], cfg, x), cache

    def _ffn(self, p: dict, x: torch.Tensor, dist: Optional[DistContext]):
        """An attention or RG-LRU layer's MLP, or an attention layer's
        experts (expert parallel on ``dist``'s mesh, locally without one):
        ``(x, aux)``, ``aux`` the experts' auxiliary loss (0 for an MLP)."""
        if "router" not in p:
            return mlp_apply(p, x), torch.zeros((), dtype=torch.float32,
                                                device=x.device)
        if dist is None:
            return moe_apply(p, self.cfg, x)
        return moe_apply(p, self.cfg, x, mesh=dist.mesh, dp_axes=dist.dp_axes,
                         ep_axis=dist.ep_axis)


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
