"""mistral-nemo-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, head_dim=128, 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=131072, head_dim=128,
    rope_theta=1000000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mistral-nemo-12b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=160, vocab=256, head_dim=16,
        block_q=64, block_kv=64, remat="none")
