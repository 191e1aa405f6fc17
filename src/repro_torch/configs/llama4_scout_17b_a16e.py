"""[moe] Llama-4-Scout-17B-16E (hf:meta-llama/Llama-4-Scout-17B-16E; unverified).
48 layers, d_model=5120, 40 heads / 8 kv, d_ff=8192, vocab 202048.
MoE: 16 experts top-1 + always-on shared expert.  Early-fusion modality
stub not exercised (assigned shapes are text-only).

Selectable as ``--arch llama4-scout-17b-a16e``.
"""
from repro_torch.models.config import ARCHS, smoke_config

NAME = "llama4-scout-17b-a16e"
CONFIG = ARCHS[NAME]
SMOKE = smoke_config(NAME)
