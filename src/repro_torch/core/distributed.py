"""Distributed (CA-)BCD / (CA-)BDCD on ``torch.distributed``.

The entry points below are thin wrappers over a
:class:`~repro_torch.core.world.SolverWorld` (the world takes the mesh's
place in the reference's signatures): every rank runs the same outer step
as the single-device solvers on its shard, with one packet all-reduce per
outer step (``engine._packet_reduce``), or, on the pipelined backend, a
two-phase ring of point-to-point hops with the next step's Gram contracted
between the phases (``engine._drive_pipelined``).

Layouts follow the paper's analysis (section 4):

* (CA-)BCD: 1D block-column -- X's data-point axis (n) sharded, vectors in
  R^n sharded, vectors in R^d replicated (Theorems 1/6).
* (CA-)BDCD: 1D block-row -- X's feature axis (d) sharded, vectors in R^d
  sharded, vectors in R^n replicated (Theorems 2/7).

Every outer step has exactly ONE synchronisation on the wire: the
``sb x (sb + 1)`` Gram||residual operand (``fuse_packet=True``) or the two
operands back to back (``False``), with the health word's slots, in one
all-reduce -- or ``2 (P - 1)`` hops and no all-reduce on the ring.  Every
rank computes on the same index stream (the paper's shared seed: the world
samples it once and hands it to all), so the overlap terms and the inner
forward substitution are local and replicated.  Each rank builds its
packet panel-free on its own contiguous shard through K1 / K3 and applies
its update through K2 / K4.
"""
from __future__ import annotations

import torch

from .engine import SolverPlan, register_solver
from .world import SolverWorld, plan_solver_world


def _plan(b, s, impl, tiles, fuse_packet, guard, fault, wire) -> SolverPlan:
    return SolverPlan(b=b, s=s, impl=impl, tiles=tiles,
                      fuse_packet=fuse_packet, guard=guard, fault=fault,
                      wire=wire)


# --------------------------------------------------------------------------
# Primal: 1D block-column
# --------------------------------------------------------------------------

def ca_bcd_sharded(world: SolverWorld, X: torch.Tensor, y: torch.Tensor,
                   lam: float, b: int, s: int, iters: int,
                   generator: torch.Generator | None = None, *,
                   fuse_packet: bool = True, idx: torch.Tensor | None = None,
                   impl: str | None = None, tiles: int | None = None,
                   guard: bool = False, fault=None,
                   x0: torch.Tensor | None = None, step0: int = 0):
    """CA-BCD with X (d, n) sharded over columns on ``world``; s = 1 is the
    classical schedule (one reduction per iteration).  Returns ``(w,
    alpha)`` on X's device -- plus the guard telemetry when ``guard`` is
    set (the health word rides the same all-reduce).  ``fault`` is the
    test-only injection hook (:class:`~repro_torch.faults.FaultPlan`,
    ``shard`` its target rank); ``x0`` / ``step0`` warm-start a segmented
    (checkpoint-resumed) solve."""
    return world.solve("primal", _plan(b, s, impl, tiles, fuse_packet, guard,
                                       fault, "psum"),
                       X, y, lam, iters, generator, idx=idx, x0=x0,
                       step0=step0)


def bcd_sharded(world: SolverWorld, X: torch.Tensor, y: torch.Tensor,
                lam: float, b: int, iters: int,
                generator: torch.Generator | None = None, *,
                fuse_packet: bool = False, idx: torch.Tensor | None = None,
                impl: str | None = None, tiles: int | None = None):
    """Classical distributed BCD (Theorem 1 schedule): the engine at s = 1,
    with the paper's separate Gram and residual operands by default."""
    return ca_bcd_sharded(world, X, y, lam, b, 1, iters, generator,
                          fuse_packet=fuse_packet, idx=idx, impl=impl,
                          tiles=tiles)


# --------------------------------------------------------------------------
# Dual: 1D block-row
# --------------------------------------------------------------------------

def ca_bdcd_sharded(world: SolverWorld, X: torch.Tensor, y: torch.Tensor,
                    lam: float, b: int, s: int, iters: int,
                    generator: torch.Generator | None = None, *,
                    fuse_packet: bool = True, idx: torch.Tensor | None = None,
                    impl: str | None = None, tiles: int | None = None,
                    guard: bool = False, fault=None,
                    x0: torch.Tensor | None = None, step0: int = 0):
    """CA-BDCD with X (d, n) sharded over rows on ``world``; the keywords as
    in :func:`ca_bcd_sharded`, ``x0`` the replicated alpha."""
    return world.solve("dual", _plan(b, s, impl, tiles, fuse_packet, guard,
                                     fault, "psum"),
                       X, y, lam, iters, generator, idx=idx, x0=x0,
                       step0=step0)


def bdcd_sharded(world: SolverWorld, X: torch.Tensor, y: torch.Tensor,
                 lam: float, b: int, iters: int,
                 generator: torch.Generator | None = None, *,
                 fuse_packet: bool = False, idx: torch.Tensor | None = None,
                 impl: str | None = None, tiles: int | None = None):
    """Classical distributed BDCD (Theorem 2 schedule)."""
    return ca_bdcd_sharded(world, X, y, lam, b, 1, iters, generator,
                           fuse_packet=fuse_packet, idx=idx, impl=impl,
                           tiles=tiles)


# --------------------------------------------------------------------------
# Pipelined backend: the same solves on the ring
# --------------------------------------------------------------------------

def ca_bcd_pipelined(world: SolverWorld, X: torch.Tensor, y: torch.Tensor,
                     lam: float, b: int, s: int, iters: int,
                     generator: torch.Generator | None = None, *,
                     fuse_packet: bool = True,
                     idx: torch.Tensor | None = None,
                     impl: str | None = None, tiles: int | None = None,
                     guard: bool = False, fault=None,
                     x0: torch.Tensor | None = None, step0: int = 0):
    """:func:`ca_bcd_sharded` on the pipelined wire: the reduction becomes
    a two-phase ring of ``2 (P - 1)`` hops, and the next outer step's Gram
    is contracted between the phases.  The ring sums in another order than
    the all-reduce, so the iterates agree to rounding, not bit for bit."""
    return world.solve("primal", _plan(b, s, impl, tiles, fuse_packet, guard,
                                       fault, "ring"),
                       X, y, lam, iters, generator, idx=idx, x0=x0,
                       step0=step0)


def ca_bdcd_pipelined(world: SolverWorld, X: torch.Tensor, y: torch.Tensor,
                      lam: float, b: int, s: int, iters: int,
                      generator: torch.Generator | None = None, *,
                      fuse_packet: bool = True,
                      idx: torch.Tensor | None = None,
                      impl: str | None = None, tiles: int | None = None,
                      guard: bool = False, fault=None,
                      x0: torch.Tensor | None = None, step0: int = 0):
    """:func:`ca_bdcd_sharded` on the pipelined ring wire."""
    return world.solve("dual", _plan(b, s, impl, tiles, fuse_packet, guard,
                                     fault, "ring"),
                       X, y, lam, iters, generator, idx=idx, x0=x0,
                       step0=step0)


# The CA wrappers (s = 1 is classical) are the canonical registry entries.
register_solver("primal", "sharded", ca_bcd_sharded)
register_solver("dual", "sharded", ca_bdcd_sharded)
register_solver("primal", "pipelined", ca_bcd_pipelined)
register_solver("dual", "pipelined", ca_bdcd_pipelined)

__all__ = ["SolverWorld", "plan_solver_world",
           "ca_bcd_sharded", "bcd_sharded", "ca_bdcd_sharded",
           "bdcd_sharded", "ca_bcd_pipelined", "ca_bdcd_pipelined"]
