"""[hybrid] RecurrentGemma-2B / Griffin (arXiv:2402.19427; hf).
26 layers in a (RG-LRU, RG-LRU, local-attn) 2:1 pattern, d_model=2560,
d_rnn=2560, 10 q heads / 1 kv head (MQA), head_dim 256, d_ff=7680,
vocab 256000, window 2048.  The RG-LRU gated recurrence is executed with the
equation-rewriting-derived parallel scan (repro_torch.core.recurrence).

Selectable as ``--arch recurrentgemma-2b``.
"""
from repro_torch.models.config import ARCHS, smoke_config

NAME = "recurrentgemma-2b"
CONFIG = ARCHS[NAME]
SMOKE = smoke_config(NAME)
