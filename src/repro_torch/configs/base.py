"""Model / run configuration schema (counterpart of ``repro/configs/base.py``).

The fields and defaults are the reference's, with torch dtypes in place of
``jnp`` ones; ``family`` selects the model in ``models/model_zoo.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEParams:
    num_experts: int
    top_k: int
    d_ff: int                    # per-expert intermediate
    capacity_factor: float = 1.25
    aux_loss_coeff: float = 0.01
    num_shared_experts: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | xlstm | hybrid | whisper | vlm
    num_layers: int
    d_model: int
    heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    # gemma3-style local:global attention
    sliding_window: Optional[int] = None    # window for local layers
    global_every: Optional[int] = None      # every Nth layer is global
    # MoE
    moe: Optional[MoEParams] = None
    moe_ep_axis: str = "data"    # mesh axis carrying EP all-to-all
    moe_tp: bool = True          # shard expert FFN intermediate over TP
    moe_token_scatter: bool = False  # shard expert queues over TP (M4)
    # qwen2-vl M-RoPE
    mrope_sections: Optional[Tuple[int, int, int]] = None
    # xLSTM
    xlstm_slstm_every: int = 4              # every Nth block is sLSTM
    # zamba2 hybrid
    ssm_state: int = 64
    shared_attn_every: int = 6
    mamba_head_dim: int = 64
    # whisper enc-dec
    enc_layers: int = 0                     # 0 = decoder-only
    max_positions: int = 1 << 20
    # numerics / execution
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    remat: bool = False
    attn_impl: str = "ref"                  # ref | flash

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.heads)

    def param_count(self) -> float:
        """Approximate parameter count (for 6ND model FLOPs)."""
        D, L, V = self.d_model, self.num_layers, self.vocab
        Dh = self.resolved_head_dim
        attn = D * Dh * (self.heads * 2 + self.kv_heads * 2)
        if self.family == "xlstm":
            per_layer = 4 * D * D + 2 * D * self.heads
        elif self.family == "hybrid":
            d_inner = 2 * D
            per_layer = D * (2 * d_inner + 2 * self.ssm_state + d_inner // self.mamba_head_dim) + d_inner * D
        else:
            per_layer = attn
        if self.moe is not None:
            per_layer += 3 * D * self.moe.d_ff * self.moe.num_experts + D * self.moe.num_experts
        elif self.family not in ("xlstm",):
            per_layer += 3 * D * self.d_ff
        total = L * per_layer + V * D * (1 if self.tie_embeddings else 2)
        if self.family == "whisper":
            enc = self.enc_layers * (attn + 2 * D * self.d_ff)
            dec_extra = L * attn  # cross attention
            total += enc + dec_extra
        return float(total)

    def active_param_count(self) -> float:
        """MoE: parameters touched per token (6*N_active*D FLOPs rule)."""
        if self.moe is None:
            return self.param_count()
        D, L = self.d_model, self.num_layers
        dense = self.param_count() - L * 3 * D * self.moe.d_ff * self.moe.num_experts
        active_ffn = L * 3 * D * self.moe.d_ff * (
            self.moe.top_k + self.moe.num_shared_experts
        )
        return float(dense + active_ffn)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution-level knobs consumed by launch/train/dry-run."""

    model: ModelConfig
    shape: ShapeConfig
    # parallelism mapping (logical axis sizes implied by the mesh)
    dp_schedule: str = "hierarchical"   # flat | hierarchical | ring2d | compressed
    microbatches: int = 1
    remat: bool = True
    fsdp: bool = True
