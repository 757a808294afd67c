"""Config system: one ModelConfig per architecture plus the shape suite
(train_4k / prefill_32k / decode_32k / long_500k), the twin of
``repro.configs.base``.

Every config file exports ``CONFIG`` (the exact published geometry) and
``reduced()`` (a same-family miniature for CPU smoke tests).  The registry in
``repro_torch.configs`` resolves ``--arch <id>`` strings.  ``dtype`` and
``param_dtype`` are torch dtypes.  ``remat`` sets the training-time
activation checkpointing (``models.api._remat``).  The fields the
reference keeps for its mesh and compiler (``fsdp``, ``scan_unroll``,
``ssd_unroll``) stay, so that a configuration reads the same in both
packages; nothing in the port reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

VOCAB_PAD_MULTIPLE = 256  # Megatron-style vocab padding for clean TP


def pad_vocab(v: int, mult: int = VOCAB_PAD_MULTIPLE) -> int:
    return -(-v // mult) * mult


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    every_n_layers: int = 1      # MoE replaces MLP on layers where i % n == n-1
    aux_loss_weight: float = 0.01
    groups: int = 1              # GShard-style dispatch groups: routing/sort/
                                 # capacity run per group (group dim follows the
                                 # batch sharding => no cross-shard sort traffic)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | ssm | audio | hybrid | moe | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    attn_layer_period: int = 1     # hybrid: 1 attn layer per this many (jamba: 8)
    enc_layers: int = 0            # enc-dec: encoder depth (seamless)
    frontend: str = "none"         # none | audio | vision (stub embedders)
    frontend_tokens: int = 0       # patches/frames occupying the prefix
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16    # activation dtype
    param_dtype: Any = torch.bfloat16
    remat: str = "full"            # full | dots | none
    fsdp: bool = False             # shard params over data axis (ZeRO-3-ish)
    # attention chunking (flash-style online-softmax attention)
    block_q: int = 512
    block_kv: int = 1024
    scan_unroll: int = 1   # dry-run cost-probe: unroll layer scans for exact HLO counts
    ssd_unroll: int = 1    # dry-run cost-probe: unroll the SSD chunk scan
    subquadratic: bool = False     # eligible for long_500k
    q_head_pad: int = 0            # extra (zero-output) q heads per kv group:
                                   # pads H to a TP-divisible count (sec Perf)

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_q_heads(self) -> int:
        return self.n_heads + self.n_kv_heads * self.q_head_pad

    def layer_kind(self, i: int) -> str:
        """attn | mamba for layer i (hybrid interleave; jamba puts the attn
        layer mid-period)."""
        if self.family == "ssm":
            return "mamba"
        if self.attn_layer_period > 1:
            return "attn" if i % self.attn_layer_period == self.attn_layer_period // 2 \
                else "mamba"
        return "attn"

    def mlp_kind(self, i: int) -> str:
        if self.moe and i % self.moe.every_n_layers == self.moe.every_n_layers - 1:
            return "moe"
        return "dense"


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    def applicable(self, cfg: ModelConfig) -> tuple[bool, str]:
        if self.name == "long_500k" and not cfg.subquadratic:
            return False, "full-attention arch: O(S^2) at 512k infeasible (DESIGN.md section 4)"
        return True, ""


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def n_params(cfg: ModelConfig) -> int:
    """Parameter count from the ParamSpec tree (every family)."""
    from repro_torch.models import api  # local import to avoid cycles
    from repro_torch.models.module import param_count
    return param_count(api.param_specs(cfg))


def n_active_params(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top_k of num_experts expert sets)."""
    total = n_params(cfg)
    if not cfg.moe:
        return total
    from repro_torch.models import api
    from repro_torch.models.module import param_count
    expert_params = param_count(api.param_specs(cfg, experts_only=True))
    active = total - expert_params + expert_params * cfg.moe.top_k // cfg.moe.num_experts
    return active
