"""repro_torch.serve -- the continuous-batching solve service over the
tenant-batched engine, the LM serving engine, and the slot table they
share."""
from .engine import Engine, ServeConfig
from .slots import SlotRequest, SlotTable, bucket_pow2
from .solver_service import SolverService, SolverServiceConfig, SolveTicket

__all__ = ["Engine", "ServeConfig", "SlotRequest", "SlotTable", "bucket_pow2",
           "SolverService", "SolverServiceConfig", "SolveTicket"]
