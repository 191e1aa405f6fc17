"""[audio] Whisper-medium encoder-decoder backbone (arXiv:2212.04356).
24 decoder + 24 encoder layers, d_model=1024, 16 heads (MHA, kv=16),
d_ff=4096, vocab 51865 (padded to 51968).  The log-mel convolution
frontend is a stub: requests carry precomputed frame embeddings ``(Se,
1024)`` (1,500 frames for 30 s of audio).  Sinusoidal positions, no RoPE,
cross-attention over the encoder's output in every decoder block.

Selectable as ``--arch whisper-medium``.
"""
from repro_torch.models.config import ARCHS, smoke_config

NAME = "whisper-medium"
CONFIG = ARCHS[NAME]
SMOKE = smoke_config(NAME)
