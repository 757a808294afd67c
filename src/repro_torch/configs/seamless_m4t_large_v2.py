"""seamless-m4t-large-v2 [audio]: enc-dec, 24L encoder + 24L decoder,
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206 (padded 256256).
[arXiv:2308.11596; hf]  Frontend is a STUB per the assignment: input_specs
provides precomputed audio frame embeddings (B, S_enc, D); S_enc = seq_len/4
(conv-subsampled frame rate, documented in EXPERIMENTS.md)."""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio", n_layers=24, enc_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192, vocab=256206,
    head_dim=64, frontend="audio", rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="seamless-m4t-large-v2-reduced", n_layers=2, enc_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, head_dim=16,
        block_q=64, block_kv=64, remat="none")
