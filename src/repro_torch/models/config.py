"""Model configurations: the port's own copy of the JAX package's
``models/config.py`` (pure Python, held equal to it by the tests).

``block_pattern`` is cycled over ``num_layers``.  The port runs the
families whose blocks are ``"attn"``, ``"attn_local"``, ``"rec"``,
``"mlstm"`` or ``"slstm"``, with or without experts (no encoder or
prefix); :class:`repro_torch.models.model.Model` raises for the others.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ARCHS", "get_config", "smoke_config"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[str, ...] = ("attn",)
    head_dim: Optional[int] = None          # default d_model // n_heads
    # attention
    window: int = 1024                      # sliding window for attn_local
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False        # arctic: dense MLP in parallel
    shared_expert: bool = False             # llama4: always-on shared expert
    # recurrent / ssm
    d_rnn: Optional[int] = None             # RG-LRU width (recurrentgemma)
    conv_width: int = 4
    n_state_heads: int = 4                  # xLSTM heads
    # families with special topology
    encoder_layers: int = 0                 # whisper: encoder depth
    prefix_len: int = 0                     # paligemma: image patch prefix
    tied_embeddings: bool = True
    # numerics / serving
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"        # int8 for qwen decode_32k
    logit_softcap: float = 0.0

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def vocab_pad(self) -> int:
        """Vocab padded to a multiple of 256 so the embedding shards over any
        mesh axis (granite 49155→49408, whisper 51865→51968; labels never
        index the pad slots)."""
        return -(-self.vocab_size // 256) * 256

    def kinds(self) -> Tuple[str, ...]:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def params_B(self) -> float:
        """Approximate parameter count (billions) — dense part + experts."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        hq, hkv, hd = self.n_heads, self.n_kv_heads, self.hd
        attn = D * hq * hd * 2 + D * hkv * hd * 2
        mlp = 3 * D * F
        per_layer = 0.0
        for kind in self.kinds():
            if kind in ("attn", "attn_local", "attn_bidir"):
                per_layer += attn + (mlp if self.n_experts == 0 else 0)
            elif kind == "rec":
                dr = self.d_rnn or D
                per_layer += 2 * D * dr + dr * D + 4 * dr + (3 * D * F)
            elif kind in ("mlstm", "slstm"):
                per_layer += 8 * D * D
            if self.n_experts and kind.startswith("attn"):
                per_layer += self.n_experts * 3 * D * F
                if self.moe_dense_residual or self.shared_expert:
                    per_layer += 3 * D * F
        embed = V * D * (1 if self.tied_embeddings else 2)
        enc = self.encoder_layers * (attn * 2 + mlp)
        return (per_layer * 1 + embed + enc) / 1e9 * (1.0)

    def active_params_B(self) -> float:
        """Active per-token params (MoE: top_k experts only) for 6ND."""
        if not self.n_experts:
            return self.params_B()
        D, F = self.d_model, self.d_ff
        total = self.params_B()
        inactive = (self.n_experts - self.top_k) * 3 * D * F * self.num_layers
        return total - inactive / 1e9


def _g():  # local:global 5:1 (gemma3)
    return ("attn_local",) * 5 + ("attn",)


ARCHS = {
    # [audio] enc-dec; conv frontend stubbed (precomputed frame embeddings)
    "whisper-medium": ModelConfig(
        name="whisper-medium", family="audio", num_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=51865,
        block_pattern=("attn",), encoder_layers=24, tied_embeddings=True,
    ),
    # [hybrid] Griffin: 2 RG-LRU blocks : 1 local-attn block
    "recurrentgemma-2b": ModelConfig(
        name="recurrentgemma-2b", family="hybrid", num_layers=26, d_model=2560,
        n_heads=10, n_kv_heads=1, d_ff=7680, vocab_size=256_000,
        block_pattern=("rec", "rec", "attn_local"), d_rnn=2560, window=2048,
        head_dim=256,
    ),
    # [dense] 5:1 local:global, 128k context
    "gemma3-12b": ModelConfig(
        name="gemma3-12b", family="dense", num_layers=48, d_model=3840,
        n_heads=16, n_kv_heads=8, d_ff=15360, vocab_size=262_144,
        block_pattern=_g(), window=1024, logit_softcap=30.0,
    ),
    "gemma3-1b": ModelConfig(
        name="gemma3-1b", family="dense", num_layers=26, d_model=1152,
        n_heads=4, n_kv_heads=1, d_ff=6912, vocab_size=262_144,
        block_pattern=_g(), window=1024, head_dim=256, logit_softcap=30.0,
    ),
    # [dense] GQA
    "granite-3-8b": ModelConfig(
        name="granite-3-8b", family="dense", num_layers=40, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=12800, vocab_size=49_155,
    ),
    # [dense] full MHA with QKV bias
    "qwen1.5-32b": ModelConfig(
        name="qwen1.5-32b", family="dense", num_layers=64, d_model=5120,
        n_heads=40, n_kv_heads=40, d_ff=27392, vocab_size=152_064,
        qkv_bias=True, kv_cache_dtype="int8",
    ),
    # [vlm] SigLIP stub prefix + gemma-style decoder, prefix-LM mask
    "paligemma-3b": ModelConfig(
        name="paligemma-3b", family="vlm", num_layers=18, d_model=2048,
        n_heads=8, n_kv_heads=1, d_ff=16384, vocab_size=257_216,
        prefix_len=256, head_dim=256,
    ),
    # [ssm] xLSTM 7:1 mLSTM:sLSTM
    "xlstm-350m": ModelConfig(
        name="xlstm-350m", family="ssm", num_layers=24, d_model=1024,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50_304,
        block_pattern=("mlstm",) * 7 + ("slstm",), n_state_heads=4,
    ),
    # [moe] 16 experts top-1 + shared expert
    "llama4-scout-17b-a16e": ModelConfig(
        name="llama4-scout-17b-a16e", family="moe", num_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=8192, vocab_size=202_048,
        n_experts=16, top_k=1, shared_expert=True,
    ),
    # [moe] 128 experts top-2 + dense residual
    "arctic-480b": ModelConfig(
        name="arctic-480b", family="moe", num_layers=35, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=4864, vocab_size=32_000,
        n_experts=128, top_k=2, moe_dense_residual=True,
    ),
}


def get_config(name: str) -> ModelConfig:
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small widths, few
    layers/experts, tiny vocab — structure preserved."""
    c = ARCHS[name]
    pat = c.block_pattern
    nl = max(len(pat), 2)
    return dataclasses.replace(
        c,
        num_layers=nl if nl % len(pat) == 0 else len(pat),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(c.n_kv_heads, 2) if c.n_kv_heads > 1 else 1,
        d_ff=128 if c.d_ff else 0,
        head_dim=16,
        vocab_size=256,
        n_experts=min(c.n_experts, 4) if c.n_experts else 0,
        d_rnn=64 if c.d_rnn else None,
        encoder_layers=2 if c.encoder_layers else 0,
        prefix_len=4 if c.prefix_len else 0,
        window=8,
        dtype="float32",
    )
