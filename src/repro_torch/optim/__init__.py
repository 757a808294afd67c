"""The optimizer of the port, the twin of ``repro.optim``: AdamW with an
f32 master and moments (``adamw``) and the warmup-cosine schedule
(``schedules``)."""
from .adamw import (AdamWConfig, adamw_update, init_opt_state,
                    opt_state_specs)
from .schedules import cosine_warmup

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "opt_state_specs",
           "cosine_warmup"]
