"""Per-architecture configs of the port.

``get("<arch-id>")`` accepts the public dashed id (e.g. "granite-3-8b").
Every id of the JAX package is listed, and the port serves every one of
them (:mod:`repro_torch.models.model`): granite, gemma3, qwen1.5,
recurrentgemma, llama4-scout, arctic, xlstm, whisper (encoder-decoder)
and paligemma (prefix-LM).
"""
from repro_torch.models.config import ARCHS, get_config, smoke_config

ARCH_IDS = tuple(ARCHS)

__all__ = ["ARCHS", "ARCH_IDS", "get", "get_config", "smoke_config"]


def get(name: str):
    return get_config(name)
