"""[vlm] PaliGemma-3B (arXiv:2407.07726).
18 layers, d_model=2048, 8 heads / 1 kv, head_dim 256, d_ff=16384, vocab
257216 (padded to 257280).  SigLIP is a stub: requests carry 256
precomputed patch embeddings ``(256, 2048)``, projected and put before the
text tokens under the prefix-LM mask (bidirectional over the patches,
causal after).

Selectable as ``--arch paligemma-3b``.
"""
from repro_torch.models.config import ARCHS, smoke_config

NAME = "paligemma-3b"
CONFIG = ARCHS[NAME]
SMOKE = smoke_config(NAME)
