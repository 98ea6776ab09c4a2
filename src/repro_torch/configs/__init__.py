"""Architecture configs (one module per ported arch) + registry."""

from .base import SHAPES, ModelConfig, MoEParams, RunConfig, ShapeConfig  # noqa: F401
from .registry import (  # noqa: F401
    ALL_CONFIGS, ARCHS, DRYRUN_ARCHS, get_config, get_smoke_config, supports_decode,
    supports_long_context,
)
