"""Architecture registry of the port: full configs + reduced smoke configs.

The dense, MoE, hybrid (zamba2) and xLSTM families are ported; asking for another
architecture of the reference's registry raises ``KeyError`` naming the
slice that brings it.
"""

from __future__ import annotations

from .base import ModelConfig
from . import (
    granite_20b, llama3_2_3b, moonshot_v1_16b_a3b, paper_llama3_moe, qwen3_8b,
    qwen3_moe_235b_a22b, xlstm_125m, zamba2_7b,
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
}

# architectures of the reference registry that later slices of the port add
_LATER = {
    "qwen2-vl-2b": "the M-RoPE (vlm) slice",
    "gemma3-4b": "the local:global attention slice",
    "whisper-large-v3": "the whisper slice",
}

ARCHS = list(_MODULES)


def _module(arch: str):
    if arch in _MODULES:
        return _MODULES[arch]
    if arch in _LATER:
        raise KeyError(f"{arch!r} is not ported yet; it comes with {_LATER[arch]}")
    raise KeyError(f"unknown architecture {arch!r}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
