"""Accelerated (momentum) CA-BCD, the fourth formulation.

Communication-efficient primal-dual work (Devarakonda et al.,
arXiv:1711.05305) shows that the s-step packet can also carry acceleration
state: the deferred block updates the engine already applies are the
increments a momentum recurrence needs.  :class:`MomentumWrapper` wraps the
primal ridge hooks with a per-coordinate velocity

    v[i] <- beta * v[i] + dw[i]        (the engine's ridge block step dw)
    w[i] <- w[i] + v[i],   alpha <- alpha + Y_i^T v[i]

kept in the carry beside ``(w, alpha)``.  The packet, the subproblem and the
sweep are the primal's, untouched: only the applied step is reshaped, on
the card by K2 (``panel_apply``) as in the primal.  ``beta = 0`` runs the
primal update itself, so it equals the primal solve bit for bit.  At
``s = 1`` the schedule is classical heavy-ball BCD; at ``s > 1`` the
velocity reshapes the deferred updates only (see
:func:`ca_accelerated_bcd`).  ``iters % s != 0`` runs a ragged tail.

The formulation is not tenant-batched, as in the reference: the batched
engine's carry is a ``(w, alpha)`` pair per tenant.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from .engine import (RowMajorOperand, SolveResult, SolverContracts,
                     SolverPlan, _BoundPrimal, _ShardedLayout, _by_block,
                     panel_apply, register_formulation, register_solver,
                     s_step_solve)


@dataclasses.dataclass(frozen=True)
class _BoundAccelerated(_BoundPrimal):
    """The primal's hooks and a velocity in the carry.  ``packet_vector``
    and ``base`` index the carry by position, so the ``(w, alpha, v)``
    carry flows through them unchanged; ``init_carry`` adds v, ``update``
    applies the momentum step and ``metrics`` drops v."""
    beta: float = 0.0

    def init_carry(self, sharded: bool = False):
        w, alpha = _BoundPrimal.init_carry(self, sharded)
        # v is laid out as w (replicated on a shard); a warm start re-enters
        # with zero velocity: the velocity is not checkpoint state (DESIGN.md
        # section 7).
        return w, alpha, torch.zeros_like(w)

    def update(self, carry, idx, dx, pp, block=None):
        w, alpha, v = carry
        if not self.beta:
            # beta = 0 runs the primal update itself: beta * v + dx == dx
            # holds only in exact arithmetic once v has rounded state.
            w, alpha = _BoundPrimal.update(self, (w, alpha), idx, dx, pp,
                                           block)
            return w, alpha, v
        il = idx.long()
        vi = self.beta * v[il] + dx
        # Block by block (see engine._by_block): where the sharded step's s
        # blocks repeat an index, its last step sets v, as the reference's
        # scatter does.
        v = _by_block(torch.Tensor.index_copy, v, il, vi, block)
        w = _by_block(torch.Tensor.index_add, w, il, vi, block)
        alpha = alpha + panel_apply(self.operand, idx, vi, plan=pp)
        return w, alpha, v

    def metrics(self, carry):
        return _BoundPrimal.metrics(self, (carry[0], carry[1]))


@dataclasses.dataclass(frozen=True)
class MomentumWrapper(_ShardedLayout):
    """Accelerated CA-BCD: samples features like the primal, in its 1D
    block-column layout (the velocity replicated like w).  ``beta`` is
    formulation state (the proximal ``lam1`` pattern): the solvers below
    build ``MomentumWrapper(beta=...)`` per call, and the registry's
    instance is what name resolution sees."""
    beta: float = 0.9
    name: ClassVar[str] = "accelerated"
    operand_layout: ClassVar[str] = "rows"

    def __post_init__(self):
        # A momentum weight outside [0, 1) does not contract.
        if not 0.0 <= self.beta < 1.0:
            raise ValueError(f"beta={self.beta!r} must be in [0, 1)")

    def contracts(self):
        # The velocity is carry state beside the replicated w: the primal's
        # wire on both schedules, the health word riding it; checked at
        # beta > 0 so that the momentum path is the one that runs.  Not
        # tenant-batched: the batched engine's carry is (w, alpha) pairs.
        return SolverContracts(sweep_kwargs=(("beta", 0.5),),
                               health_in_packet=True, tenant_batched=False)

    def sample_dim(self, d, n):
        return d

    def bind(self, X, y, lam, *, x0=None, w_ref=None):
        d, n = X.shape
        return _BoundAccelerated(operand=RowMajorOperand(X), y=y, lam=lam,
                                 n=n, d=d, w0=x0, w_ref=w_ref, beta=self.beta)

    def bind_shard(self, Xl, yl, lam, *, d, n, x0=None):
        return _BoundAccelerated(operand=RowMajorOperand(Xl), y=yl, lam=lam,
                                 n=n, d=d, w0=x0, beta=self.beta)


def accelerated_bcd(X: torch.Tensor, y: torch.Tensor, lam: float, b: int,
                    iters: int, generator: torch.Generator | None = None, *,
                    beta: float = 0.9, w0: torch.Tensor | None = None,
                    idx: torch.Tensor | None = None,
                    w_ref: torch.Tensor | None = None,
                    impl: str | None = None,
                    tiles: int | None = None) -> SolveResult:
    """Classical momentum BCD: the engine at s = 1.  ``beta = 0`` is
    :func:`~.bcd.bcd`."""
    plan = SolverPlan(b=b, s=1, impl=impl, tiles=tiles)
    return s_step_solve(MomentumWrapper(beta=beta), plan, X, y, lam, iters,
                        generator, x0=w0, idx=idx, w_ref=w_ref)


def ca_accelerated_bcd(X: torch.Tensor, y: torch.Tensor, lam: float, b: int,
                       s: int, iters: int,
                       generator: torch.Generator | None = None, *,
                       beta: float = 0.9, w0: torch.Tensor | None = None,
                       idx: torch.Tensor | None = None,
                       w_ref: torch.Tensor | None = None,
                       track_cond: bool = False, impl: str | None = None,
                       tiles: int | None = None, guard: bool = False,
                       fault=None, step0: int = 0) -> SolveResult:
    """CA momentum BCD (arXiv:1711.05305): one sb x sb Gram packet per outer
    step, then ``s`` momentum-applied block solves.

    At ``s = 1`` this is classical heavy-ball BCD.  At ``s > 1`` the
    momentum rides the deferred block updates: the sweep's corrections
    assume the plain ``dx`` steps, and the velocity reshapes only the
    applied update (the CoCoA-style local-subproblem flexibility,
    arXiv:1409.1458), not an exact reordering of the classical momentum
    schedule.  ``beta = 0`` recovers CA-BCD bit for bit at every ``s``.
    ``guard``, ``fault`` and ``step0`` as in :func:`~.bcd.ca_bcd`."""
    plan = SolverPlan(b=b, s=s, impl=impl, tiles=tiles, track_cond=track_cond,
                      guard=guard, fault=fault)
    return s_step_solve(MomentumWrapper(beta=beta), plan, X, y, lam, iters,
                        generator, x0=w0, idx=idx, w_ref=w_ref, step0=step0)


def ca_accelerated_bcd_sharded(world, X: torch.Tensor, y: torch.Tensor,
                               lam: float, b: int, s: int, iters: int,
                               generator: torch.Generator | None = None, *,
                               beta: float = 0.9, fuse_packet: bool = True,
                               idx: torch.Tensor | None = None,
                               impl: str | None = None,
                               tiles: int | None = None, guard: bool = False,
                               fault=None, x0: torch.Tensor | None = None,
                               step0: int = 0):
    """Distributed CA momentum BCD on ``world``
    (:class:`~repro_torch.core.world.SolverWorld`): the primal's layout, ONE
    packet all-reduce per outer step; the velocity is replicated carry
    state, so momentum adds no communication.  Returns ``(w, alpha)``, with
    the guard telemetry as a third item when ``guard`` is set."""
    plan = SolverPlan(b=b, s=s, impl=impl, tiles=tiles,
                      fuse_packet=fuse_packet, guard=guard, fault=fault)
    return world.solve(MomentumWrapper(beta=beta), plan, X, y, lam, iters,
                       generator, idx=idx, x0=x0, step0=step0)


def ca_accelerated_bcd_pipelined(world, X: torch.Tensor, y: torch.Tensor,
                                 lam: float, b: int, s: int, iters: int,
                                 generator: torch.Generator | None = None, *,
                                 beta: float = 0.9, fuse_packet: bool = True,
                                 idx: torch.Tensor | None = None,
                                 impl: str | None = None,
                                 tiles: int | None = None,
                                 guard: bool = False, fault=None,
                                 x0: torch.Tensor | None = None,
                                 step0: int = 0):
    """:func:`ca_accelerated_bcd_sharded` on the pipelined ring wire."""
    plan = SolverPlan(b=b, s=s, impl=impl, tiles=tiles,
                      fuse_packet=fuse_packet, guard=guard, fault=fault,
                      wire="ring")
    return world.solve(MomentumWrapper(beta=beta), plan, X, y, lam, iters,
                       generator, idx=idx, x0=x0, step0=step0)


register_formulation(MomentumWrapper())
register_solver("accelerated", "local", ca_accelerated_bcd)
register_solver("accelerated", "sharded", ca_accelerated_bcd_sharded)
register_solver("accelerated", "pipelined", ca_accelerated_bcd_pipelined)
