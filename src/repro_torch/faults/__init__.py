"""Fault injection and supervised solves for the s-step engine (DESIGN.md
section 7).  ``FaultPlan`` imports light (the solvers take it as a plan
field); the supervisor and its checkpoint stack are imported on first use."""
from .plan import KINDS, FaultPlan

__all__ = ["FaultPlan", "KINDS", "DeviceLostError", "SupervisedResult",
           "solve_supervised"]


def __getattr__(name):
    if name in ("DeviceLostError", "SupervisedResult", "solve_supervised"):
        from . import supervisor
        return getattr(supervisor, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
