"""The LM serving path of the port: configurations, the layer library and
the model assembly for dense, attention-only LMs (granite-3-8b), with
prefill attention on the flash-attention kernel."""
from .config import ARCHS, ModelConfig, get_config, smoke_config
from .model import Model, check_supported

__all__ = ["ARCHS", "ModelConfig", "get_config", "smoke_config", "Model",
           "check_supported"]
