"""[dense] Gemma-3-1B (hf:google/gemma-3-1b-pt; unverified).
26 layers, 5:1 local:global, window 1024, d_model=1152, 4 heads / 1 kv,
head_dim 256, d_ff=6912, vocab 262144, logit softcap 30.

Selectable as ``--arch gemma3-1b``; the port's serving launcher default.
"""
from repro_torch.models.config import ARCHS, smoke_config

NAME = "gemma3-1b"
CONFIG = ARCHS[NAME]
SMOKE = smoke_config(NAME)
