"""The LM serving path of the port: configurations, the layer library,
the recurrent blocks (RG-LRU, mLSTM, sLSTM), the mixture of experts and
the model assembly for granite, gemma3, qwen1.5, RecurrentGemma,
llama4-scout, arctic, xLSTM, whisper and paligemma, with prefill
attention on the flash-attention kernel."""
from .config import ARCHS, ModelConfig, get_config, smoke_config
from .model import DistContext, Model, check_supported

__all__ = ["ARCHS", "ModelConfig", "get_config", "smoke_config", "Model",
           "DistContext", "check_supported"]
