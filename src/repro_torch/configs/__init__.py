from .base import ModelConfig, QuantConfig
from .registry import ARCH_IDS, CONFIGS, get_config

__all__ = ["ARCH_IDS", "CONFIGS", "ModelConfig", "QuantConfig", "get_config"]
