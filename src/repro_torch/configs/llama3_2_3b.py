"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B family; unverified]  24 q-heads do not divide
TP=16 -> attention weights replicate over 'model' (guarded rule; see
DESIGN.md section 4); MLP/vocab are TP-sharded."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense", n_layers=28, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=8192, vocab=128256, head_dim=128,
    rope_theta=500000.0, tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llama3.2-3b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
        block_q=64, block_kv=64, remat="none")
