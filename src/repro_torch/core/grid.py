"""A grid of ranks: ``{"pod": P, "data": D, "model": M}`` ("pod" optional),
the port's stand-in for the reference's device mesh.  Ranks lie on it in
row-major order of its axes, model fastest, as a mesh orders its devices.
``core.world`` lays its ranks and groups out by it; ``models.sharding``
cuts tensors by it.
"""
from __future__ import annotations

import math

GRID_AXES = ("pod", "data", "model")


def as_grid(grid) -> dict:
    """A grid as ``{axis: size}`` in (pod, data, model) order: a mapping,
    or a tuple ``(data, model)`` / ``(pod, data, model)``."""
    if isinstance(grid, dict):
        extra = set(grid) - set(GRID_AXES)
        if extra or "data" not in grid or "model" not in grid:
            raise ValueError(f"a grid has the axes data, model and an "
                             f"optional pod, not {sorted(grid)}")
        out = {a: int(grid[a]) for a in GRID_AXES if a in grid}
    else:
        grid = tuple(int(n) for n in grid)
        if len(grid) not in (2, 3):
            raise ValueError(f"grid {grid}: (data, model) or (pod, data, "
                             "model)")
        out = dict(zip(GRID_AXES[3 - len(grid):], grid))
    if any(n < 1 for n in out.values()):
        raise ValueError(f"grid {out}: every axis needs at least one rank")
    return out


def grid_name(grid) -> str:
    """``"16x16"`` / ``"2x16x16"``: the sizes joined in axis order."""
    return "x".join(str(n) for n in as_grid(grid).values())


def grid_size(grid) -> int:
    return math.prod(as_grid(grid).values())


def coords_of(rank: int, grid) -> dict:
    """The grid coordinates of ``rank`` (row-major, model fastest)."""
    grid = as_grid(grid)
    if not 0 <= rank < grid_size(grid):
        raise ValueError(f"rank {rank} is not on the grid {grid}")
    out = {}
    for axis in reversed(grid):
        rank, out[axis] = divmod(rank, grid[axis])
    return {a: out[a] for a in grid}
