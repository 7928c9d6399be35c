from .base import SHAPES, ModelConfig, ShapeConfig  # noqa: F401
from .registry import ARCH_NAMES, cell_applicable, get_config, get_shape  # noqa: F401
