"""[moe] Snowflake Arctic 480B (hf:Snowflake/snowflake-arctic-base; hf).
35 layers, d_model=7168, 56 heads / 8 kv, d_ff=4864, vocab 32000.
MoE: 128 experts top-2 PLUS a parallel dense residual MLP per layer.

Selectable as ``--arch arctic-480b``.
"""
from repro_torch.models.config import ARCHS, smoke_config

NAME = "arctic-480b"
CONFIG = ARCHS[NAME]
SMOKE = smoke_config(NAME)
