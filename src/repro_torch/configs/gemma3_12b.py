"""[dense] Gemma-3-12B (hf:google/gemma-3-1b-pt family; unverified).
48 layers, 5:1 local:global attention, window 1024, d_model=3840, 16 heads /
8 kv, d_ff=15360, vocab 262144, logit softcap 30.

Selectable as ``--arch gemma3-12b``.
"""
from repro_torch.models.config import ARCHS, smoke_config

NAME = "gemma3-12b"
CONFIG = ARCHS[NAME]
SMOKE = smoke_config(NAME)
