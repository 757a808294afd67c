"""repro_torch.serve -- the continuous-batching solve service over the
tenant-batched engine, and its slot table."""
from .slots import SlotRequest, SlotTable, bucket_pow2
from .solver_service import SolverService, SolverServiceConfig, SolveTicket

__all__ = ["SlotRequest", "SlotTable", "bucket_pow2", "SolverService",
           "SolverServiceConfig", "SolveTicket"]
