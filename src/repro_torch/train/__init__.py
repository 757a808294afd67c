"""Training of the port, the twin of ``repro.train``: the train step and the
``Trainer`` driver (``trainer``), and data-parallel elastic restarts over a
world of ranks (``elastic``).  The reference's ``train_step_shardings``
and ``abstract_train_state`` (its mesh's shardings) have no twin."""
from .trainer import (TrainState, Trainer, TrainRunConfig, make_train_step,
                      train_state_specs)
from .elastic import plan_mesh, reshard_state, run_data_parallel

__all__ = ["TrainState", "Trainer", "TrainRunConfig", "make_train_step",
           "train_state_specs", "reshard_state", "plan_mesh",
           "run_data_parallel"]
