"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752, MoE 16e top-4
(fine-grained), vocab=100352.  [hf:databricks/dbrx-base; unverified]
fsdp=True: 132B params need data-axis parameter sharding."""
import dataclasses
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=10752, vocab=100352, head_dim=128,
    moe=MoEConfig(num_experts=16, top_k=4), rope_theta=500000.0, fsdp=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="dbrx-132b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
        moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=4.0),
        block_q=64, block_kv=64, remat="none", fsdp=False)
