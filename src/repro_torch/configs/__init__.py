from .base import SHAPES, ModelConfig, QuantConfig, ShapeConfig, supported_shapes
from .registry import ARCH_IDS, CONFIGS, all_cells, get_config

__all__ = ["ARCH_IDS", "CONFIGS", "SHAPES", "ModelConfig", "QuantConfig", "ShapeConfig",
           "all_cells", "get_config", "supported_shapes"]
