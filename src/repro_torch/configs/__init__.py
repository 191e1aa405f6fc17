"""Per-architecture configs of the port.

``get("<arch-id>")`` accepts the public dashed id (e.g. "granite-3-8b").
Every id of the JAX package is listed; the port serves granite, gemma3,
qwen1.5 and recurrentgemma (:mod:`repro_torch.models.model`).
"""
from repro_torch.models.config import ARCHS, get_config, smoke_config

ARCH_IDS = tuple(ARCHS)

__all__ = ["ARCHS", "ARCH_IDS", "get", "get_config", "smoke_config"]


def get(name: str):
    return get_config(name)
