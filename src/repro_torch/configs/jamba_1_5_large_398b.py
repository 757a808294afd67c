"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2 on alternating layers, Mamba:attn 7:1 interleave
(attention at position 4 of each 8-layer period).  [arXiv:2403.19887; hf]
Sub-quadratic overall (KV cache only on 9 of 72 layers) -> runs long_500k.
fsdp=True: 398B params exceed per-chip HBM under pure TP."""
import dataclasses
from .base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=24576, vocab=65536, head_dim=128,
    moe=MoEConfig(num_experts=16, top_k=2, every_n_layers=2),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=128, chunk=128),
    attn_layer_period=8, subquadratic=True, fsdp=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="jamba-1.5-large-398b-reduced", n_layers=8, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
        moe=MoEConfig(num_experts=4, top_k=2, every_n_layers=2,
                      capacity_factor=4.0),  # no-drop for exactness tests
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32),
        block_q=64, block_kv=64, remat="none", fsdp=False)
