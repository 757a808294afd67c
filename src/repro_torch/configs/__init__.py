"""Architecture registry of the port: ``--arch <id>`` resolves here, as in
``repro.configs``.

Each module exports CONFIG (published geometry, source cited in the file) and
reduced() (CPU-smoke miniature of the same family).
"""
from __future__ import annotations

import importlib

from .base import (ModelConfig, MoEConfig, ShapeConfig, SSMConfig, SHAPES,
                   n_active_params, n_params, pad_vocab)

ARCH_IDS = [
    "llama3_2_3b",
    "mistral_nemo_12b",
    "qwen2_0_5b",
    "granite_3_2b",
    "mamba2_370m",
    "seamless_m4t_large_v2",
    "jamba_1_5_large_398b",
    "dbrx_132b",
    "phi3_5_moe_42b",
    "llava_next_34b",
]

# public --arch aliases (hyphenated, as in the assignment) -> module name
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({
    "llama3.2-3b": "llama3_2_3b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "qwen2-0.5b": "qwen2_0_5b",
    "granite-3-2b": "granite_3_2b",
    "mamba2-370m": "mamba2_370m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "dbrx-132b": "dbrx_132b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "phi3.5-moe-42b": "phi3_5_moe_42b",
    "llava-next-34b": "llava_next_34b",
})


def get_config(arch: str) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def get_reduced(arch: str) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.reduced()


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "SHAPES",
           "ARCH_IDS", "ALIASES", "get_config", "get_reduced", "n_params",
           "n_active_params", "pad_vocab"]
