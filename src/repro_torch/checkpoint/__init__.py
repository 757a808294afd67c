"""Snapshots of tensor trees with CRC checks, atomic commits and an async
writer; the supervisor's restart path (``repro_torch.faults``)."""
from .checkpointer import CheckpointManager, CheckpointWriteError

__all__ = ["CheckpointManager", "CheckpointWriteError"]
