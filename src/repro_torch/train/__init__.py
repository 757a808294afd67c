"""Training of the port, the twin of ``repro.train``: the train step and the
``Trainer`` loop on one rank, a world of ranks or a grid of them
(``trainer``: ``train_step_shardings`` and ``abstract_train_state`` give
a rank's specs and meta tree on a grid), and elastic restarts onto
another world or grid (``elastic``)."""
from .trainer import (TrainState, Trainer, TrainRunConfig,
                      abstract_train_state, make_train_step,
                      train_state_specs, train_step_shardings)
from .elastic import plan_mesh, reshard_state, run_data_parallel

__all__ = ["TrainState", "Trainer", "TrainRunConfig", "make_train_step",
           "train_state_specs", "train_step_shardings",
           "abstract_train_state", "reshard_state", "plan_mesh",
           "run_data_parallel"]
