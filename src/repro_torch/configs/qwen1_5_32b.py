"""[dense] Qwen1.5-32B (hf:Qwen/Qwen1.5-0.5B family; hf).
64 layers, d_model=5120, 40 heads / 40 kv (full MHA), QKV bias, d_ff=27392,
vocab 152064.  decode_32k uses the int8 KV cache (full-MHA cache at
32k x 128 would be 5.5 TB bf16).

Selectable as ``--arch qwen1.5-32b``.
"""
from repro_torch.models.config import ARCHS, smoke_config

NAME = "qwen1.5-32b"
CONFIG = ARCHS[NAME]
SMOKE = smoke_config(NAME)
