"""[dense] Granite-3.0-8B (hf:ibm-granite/granite-3.0-8b-base).
40 layers, d_model=4096, 32 heads / 8 kv (GQA), head_dim 128, d_ff=12800,
vocab 49155 (padded to 49408), every block causal attention.

Selectable as ``--arch granite-3-8b``.
"""
from repro_torch.models.config import ARCHS, smoke_config

NAME = "granite-3-8b"
CONFIG = ARCHS[NAME]
SMOKE = smoke_config(NAME)
