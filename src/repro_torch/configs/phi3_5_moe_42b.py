"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400,
MoE 16e top-2, vocab=32064 (padded 32256). [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
import dataclasses
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=6400, vocab=32064, head_dim=128,
    moe=MoEConfig(num_experts=16, top_k=2), rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="phi3.5-moe-42b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
        moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=4.0),
        block_q=64, block_kv=64, remat="none")
