"""The model layer of the port, the twin of ``repro.models``: functional
layers, the Mamba-2 block (``mamba2``), the mixture-of-experts block
(``moe``), the decoder and encoder-decoder bodies (``api``), and the
rule table of the reference's mesh layout over a grid of ranks
(``sharding``).  The reference's ``abstract_params`` (the port's meta
tensors, ``launch.inputs``) and ``constrain`` (activations are placed by
the layers) have no twin."""
from . import api, layers, mamba2, moe, sharding
from .api import DecoderLM, EncDecLM
from .module import (ParamSpec, init_params, param_bytes, param_count,
                     stack_specs)
from .sharding import BASE_RULES, ShardingRules, make_rules

__all__ = ["api", "layers", "mamba2", "moe", "sharding", "DecoderLM",
           "EncDecLM", "ParamSpec", "init_params", "param_bytes",
           "param_count", "stack_specs", "BASE_RULES", "ShardingRules",
           "make_rules"]
