"""The LM serving path of the port: configurations, the layer library,
the RG-LRU block and the model assembly for granite, gemma3, qwen1.5 and
RecurrentGemma, with prefill attention on the flash-attention kernel."""
from .config import ARCHS, ModelConfig, get_config, smoke_config
from .model import Model, check_supported

__all__ = ["ARCHS", "ModelConfig", "get_config", "smoke_config", "Model",
           "check_supported"]
