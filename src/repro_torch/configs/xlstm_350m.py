"""[ssm] xLSTM-350M (arXiv:2405.04517; unverified).
24 layers in a 7:1 mLSTM:sLSTM pattern, d_model=1024, 4 state heads,
d_ff=0 (blocks own their pf=2 / pf=4/3 expansions), vocab 50304.
mLSTM prefills chunkwise-parallel; sLSTM is inherently sequential (a
loop over the prompt's steps).

Selectable as ``--arch xlstm-350m``.
"""
from repro_torch.models.config import ARCHS, smoke_config

NAME = "xlstm-350m"
CONFIG = ARCHS[NAME]
SMOKE = smoke_config(NAME)
