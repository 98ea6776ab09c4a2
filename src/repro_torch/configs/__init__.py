"""Architecture configs (one module per ported arch) + registry."""

from .base import SHAPES, ModelConfig, MoEParams, ShapeConfig  # noqa: F401
from .registry import ARCHS, get_config, get_smoke_config  # noqa: F401
