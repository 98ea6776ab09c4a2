"""Architecture registry of the port: full configs + reduced smoke configs.

Every architecture of the reference's registry: the dense (with gemma3's
local:global windows), MoE, hybrid (zamba2), xLSTM, vlm (qwen2-vl, M-RoPE)
and whisper (encoder-decoder) families.  An unknown name raises
``KeyError``.
"""

from __future__ import annotations

from .base import ModelConfig
from . import (
    gemma3_4b, granite_20b, llama3_2_3b, moonshot_v1_16b_a3b, paper_llama3_moe, qwen2_vl_2b,
    qwen3_8b, qwen3_moe_235b_a22b, whisper_large_v3, xlstm_125m, zamba2_7b,
)

_MODULES = {
    "qwen3-8b": qwen3_8b,
    "llama3.2-3b": llama3_2_3b,
    "granite-20b": granite_20b,
    "zamba2-7b": zamba2_7b,
    "xlstm-125m": xlstm_125m,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "paper-llama3-moe": paper_llama3_moe,
    "qwen2-vl-2b": qwen2_vl_2b,
    "gemma3-4b": gemma3_4b,
    "whisper-large-v3": whisper_large_v3,
}

ARCHS = list(_MODULES)
ALL_CONFIGS = list(_MODULES)
# the reference's ``ARCHS``: every name but paper-llama3-moe, in its order
# (the dry run's ``--all``)
DRYRUN_ARCHS = ["xlstm-125m", "qwen3-moe-235b-a22b", "moonshot-v1-16b-a3b", "qwen2-vl-2b",
                "qwen3-8b", "llama3.2-3b", "granite-20b", "gemma3-4b", "whisper-large-v3",
                "zamba2-7b"]


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown architecture {arch!r}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def supports_decode(arch: str) -> bool:
    return True  # every name has a decoder (whisper is encoder-decoder)


def supports_long_context(arch: str) -> bool:
    """long_500k runs only for the sub-quadratic families, xLSTM and the
    hybrid."""
    return get_config(arch).family in ("xlstm", "hybrid")
