"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 (padded to 49408 for TP; Megatron-style).
[hf:ibm-granite/granite-3.0-2b-base; hf]"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab=49155, head_dim=64,
    rope_theta=10000.0, tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="granite-3-2b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=250, head_dim=16,
        block_q=64, block_kv=64, remat="none")
