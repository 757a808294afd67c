"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936,
QKV bias. [arXiv:2407.10671; hf]  14 heads / 2 kv heads do not divide TP=16
-> attention replicated over 'model' (guarded)."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, d_ff=4864, vocab=151936, head_dim=64,
    qkv_bias=True, rope_theta=1000000.0, tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-0.5b-reduced", n_layers=2, d_model=64,
        n_heads=2, n_kv_heads=1, d_ff=128, vocab=256, head_dim=32,
        block_q=64, block_kv=64, remat="none")
