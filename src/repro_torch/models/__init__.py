"""The model layer of the port, the twin of ``repro.models``: functional
layers, the Mamba-2 block (``mamba2``), the mixture-of-experts block
(``moe``), and the decoder and encoder-decoder bodies (``api``).  The
reference's ``abstract_params`` and its mesh sharding rules have no twin
yet."""
from . import api, layers, mamba2, moe
from .api import DecoderLM, EncDecLM
from .module import (ParamSpec, init_params, param_bytes, param_count,
                     stack_specs)

__all__ = ["api", "layers", "mamba2", "moe", "DecoderLM", "EncDecLM",
           "ParamSpec", "init_params", "param_bytes", "param_count",
           "stack_specs"]
