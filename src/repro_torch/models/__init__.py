"""The model layer of the port: functional layers and the decoder body
(dense and vlm families), the twin of ``repro.models``.  The reference's
``mamba2`` and ``moe`` modules, its encoder-decoder body, its
``abstract_params`` and its mesh sharding rules have no twin yet."""
from . import api, layers
from .api import DecoderLM
from .module import (ParamSpec, init_params, param_bytes, param_count,
                     stack_specs)

__all__ = ["api", "layers", "DecoderLM", "ParamSpec", "init_params",
           "param_bytes", "param_count", "stack_specs"]
