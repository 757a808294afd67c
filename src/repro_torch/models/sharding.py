"""Logical-axis -> grid-axis sharding rules with divisibility guards, the
twin of ``repro.models.sharding``.

The reference's rule table maps a logical axis to a tuple of mesh axes;
the guard drops any mapping whose axis product does not divide the
dimension (llama3.2's 24 query heads cannot shard over model = 16 and are
replicated; the drop is recorded in ``dropped``) and any axis absent from
the mesh (one table serves the 16 x 16 and 2 x 16 x 16 meshes: 'pod'
vanishes on the first).  The port keeps the table and the guard as they
are, over a *grid of ranks* in place of a device mesh: a grid is a mapping
``{"pod": P, "data": D, "model": M}`` ("pod" optional), which is all the
rules read of a mesh.  A spec is the reference's ``PartitionSpec`` as a
tuple, one entry a dimension: ``None`` (replicated), an axis name, or a
tuple of axis names (the dimension cut over their product, the first
axis slowest).

Ranks lie on the grid in row-major order of its axes (pod, data, model):
rank ``((p D) + d) M + m`` is at ``{"pod": p, "data": d, "model": m}``, as
a device mesh orders its devices (``core.grid``).  What torch needs beyond the rules:
:func:`shard_shape` (a rank's block of a dimension-cut tensor),
:func:`cut` (the rank's block of a whole tensor, a view; :func:`cut_tree`
a copy of every leaf's) and :func:`assemble` (the whole tensor from every
rank's block, the replicated copies checked to be the same bits).

The reference's ``constrain`` (``with_sharding_constraint`` on an
activation) has no twin: a compiler places the reference's activations,
while the port's are placed by the code that computes them (the
tensor-parallel layers of ``models.api`` keep each activation whole or
cut over 'model' as the layer's collective leaves it).  ``sharding_for`` /
``named`` (``NamedSharding`` objects of the mesh) have none either; the
spec is the whole description here.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.grid import as_grid, coords_of, grid_size
from .module import ParamSpec, tree_map

# One shared rule table.  "fsdp" entries are merged in when the config asks
# for parameter sharding over the data axis (ZeRO-3 style for the >100B archs).
BASE_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "inner": ("model",),        # mamba d_inner / heads
    "cache_seq": (),            # overridden to ("model",) for seq-sharded decode
    "seq": (),
    "embed": (),
    "layers": (),
    "head_dim": (),
    "state": (),
    "conv": (),
    "capacity": (),
    "data_points": ("pod", "data", "model"),  # solver 1D-block-column layout
    "features": ("pod", "data", "model"),     # solver 1D-block-row layout
}

FSDP_RULES = {
    "embed": ("data",),         # shard the non-TP dim of weight matrices
}

@dataclasses.dataclass
class ShardingRules:
    grid: dict
    rules: dict[str, tuple[str, ...]]
    dropped: list  # (logical, dim, axes, reason) audit trail

    def spec_for(self, shape: tuple[int, ...], axes: tuple[str | None, ...]
                 ) -> tuple:
        used: set[str] = set()
        parts = []
        for dim, logical in zip(shape, axes):
            choice = None
            if logical is not None:
                candidates = self.rules.get(logical, ())
                # keep only axes present in the grid and not yet used
                cand = tuple(a for a in candidates
                             if a in self.grid and a not in used)
                # try the full tuple, then singletons
                options = []
                if cand:
                    options.append(cand)
                    options.extend((a,) for a in cand if len(cand) > 1)
                for opt in options:
                    size = math.prod(self.grid[a] for a in opt)
                    if dim % size == 0:
                        choice = opt
                        used.update(opt)
                        break
                if choice is None and cand:
                    self.dropped.append((logical, dim, cand, "indivisible"))
            parts.append(choice if choice is None or len(choice) > 1
                         else choice[0])
        return tuple(parts)

    def spec_of(self, spec: ParamSpec) -> tuple:
        return self.spec_for(spec.shape, spec.axes)

    def tree(self, specs) -> dict:
        """The spec of every ParamSpec leaf of a tree."""
        return tree_map(self.spec_of, specs)


def make_rules(grid, *, fsdp: bool = False,
               overrides: dict[str, tuple[str, ...]] | None = None
               ) -> ShardingRules:
    rules = dict(BASE_RULES)
    if fsdp:
        rules.update(FSDP_RULES)
    if overrides:
        rules.update(overrides)
    return ShardingRules(as_grid(grid), rules, dropped=[])


def entry_axes(entry) -> tuple:
    """The grid axes of one spec entry (``()`` for a replicated dim)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: tuple) -> set:
    """Every grid axis a spec cuts over."""
    return {a for e in spec for a in entry_axes(e)}


def shard_shape(shape, spec: tuple, grid) -> tuple:
    """A rank's block shape of a tensor of ``shape`` cut by ``spec``."""
    grid = as_grid(grid)
    out = []
    for dim, e in zip(shape, spec):
        n = math.prod(grid[a] for a in entry_axes(e))
        if dim % n:
            raise ValueError(f"dimension {dim} does not split over {e} "
                             f"({n} ranks)")
        out.append(dim // n)
    return tuple(out)


def block_index(entry, grid, coords: dict) -> tuple[int, int]:
    """(index, count) of a rank's block along a dimension cut by
    ``entry``: the entry's axes row-major, the first slowest."""
    index, count = 0, 1
    for a in entry_axes(entry):
        index = index * grid[a] + coords[a]
        count *= grid[a]
    return index, count


def cut(t, spec: tuple, grid, coords: dict):
    """The block of ``t`` (a tensor, or a numpy array) that the rank at
    ``coords`` holds under ``spec``: a view."""
    grid = as_grid(grid)
    idx = []
    for dim, e in zip(t.shape, spec):
        i, n = block_index(e, grid, coords)
        if dim % n:
            raise ValueError(f"dimension {dim} does not split over {e} "
                             f"({n} ranks)")
        size = dim // n
        idx.append(slice(i * size, (i + 1) * size))
    return t[tuple(idx)]


def cut_tree(tree, specs, grid, coords: dict, dtype=None, device=None):
    """:func:`cut` of every leaf of ``tree`` by the spec at its path in
    ``specs``, copied contiguous (in ``dtype`` and on ``device`` when
    given; a leaf may be a tensor or a numpy array)."""
    if isinstance(tree, dict):
        return {k: cut_tree(tree[k], specs[k], grid, coords, dtype, device)
                for k in tree}
    t = torch.as_tensor(tree)
    return cut(t, specs, grid, coords).to(
        device=device or t.device, dtype=dtype or t.dtype,
        memory_format=torch.contiguous_format, copy=True)


def map_specs(fn, specs, shardings):
    """``fn(ParamSpec, spec)`` over a spec tree and its shardings (the
    same keys), as a tree of the results."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, specs[k], shardings[k]) for k in specs}
    return fn(specs, shardings)


def assemble_tree(trees: list, specs, grid):
    """:func:`assemble` of every leaf of the ranks' ``trees`` (rank order)
    by the spec at its path in ``specs``."""
    if isinstance(specs, dict):
        return {k: assemble_tree([t[k] for t in trees], specs[k], grid)
                for k in specs}
    return assemble(trees, specs, grid)


def assemble(blocks: list, spec: tuple, grid) -> torch.Tensor:
    """The whole tensor from every rank's block (``blocks`` in rank
    order).  Ranks that hold the same block (the axes ``spec`` does not
    cut over) must hold the same bits: raises otherwise."""
    grid = as_grid(grid)
    if len(blocks) != grid_size(grid):
        raise ValueError(f"{len(blocks)} blocks for the grid {grid}")
    first = blocks[0]
    full = tuple(s * block_index(e, grid, coords_of(0, grid))[1]
                 for s, e in zip(first.shape, spec))
    out = first.new_empty(full)
    seen = {}
    for rank, b in enumerate(blocks):
        coords = coords_of(rank, grid)
        key = tuple(block_index(e, grid, coords)[0] for e in spec)
        if key in seen:
            if not torch.equal(seen[key], b):
                raise RuntimeError(
                    f"ranks holding block {key} of a leaf cut by {spec} "
                    f"differ (rank {rank})")
            continue
        seen[key] = b
        cut(out, spec, grid, coords).copy_(b)
    return out
