"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 backbone; anyres tiling -> 2880 patch embeddings prefix
(5 tiles x 576), provided precomputed by the stub frontend per the
assignment.  [hf:llava-hf family; unverified]  56 heads do not divide TP=16
-> attention replicated over 'model' (guarded; see section Perf hillclimb for
the 8-way alternative)."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000, head_dim=128,
    frontend="vision", frontend_tokens=2880, rope_theta=5000000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llava-next-34b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
        frontend_tokens=16, block_q=64, block_kv=64, remat="none")
