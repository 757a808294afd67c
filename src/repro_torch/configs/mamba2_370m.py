"""mamba2-370m [ssm]: 48L d_model=1024, attention-free SSD, ssm_state=128,
vocab=50280 (padded 50432). [arXiv:2405.21060; unverified]  Sub-quadratic:
runs the long_500k cell (decode state is O(1) per token)."""
import dataclasses
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm", n_layers=48, d_model=1024,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    subquadratic=True, tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-370m-reduced", n_layers=2, d_model=64,
        vocab=256, ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                                 chunk=32), remat="none")
