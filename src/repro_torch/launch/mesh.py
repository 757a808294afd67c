"""The production meshes as grids of ranks, the twin of
``repro.launch.mesh``.

A function, not a constant, as in the reference; here it touches no device
at all: a grid is its axis names and sizes
(``core.grid.as_grid``), what the rule table and the dry run's
analytic records read.  The reference's 256 / 512 TPU chips are not ranks
this port can start on one card: ``launch.dryrun --mesh`` computes a rank's
bytes on these grids from the specs, and the trainer runs on the small
grids that fit (``train.trainer``).
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """16 x 16 = 256 ranks a pod ('data', 'model'); ``multi_pod`` prepends
    a 2-pod axis ('pod', 'data', 'model') = 512 ranks."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}
