"""CA proximal (elastic-net) block coordinate descent, the third formulation:

    min_w  1/(2n) ||X^T w - y||^2 + lam/2 ||w||^2 + lam1 ||w||_1,   X in R^{d x n},

on the s-step engine, per the proximal communication-avoiding methods of
Devarakonda et al. (arXiv:1712.06047): the primal's sb x sb Gram packet
(kernels K1/K2, and K6 in the batched engine), with a soft-threshold inside
the inner recurrence (``subproblem.block_forward_substitution_prox``).

Block update (s = 1): sample b features ``i``, form

    Gamma = Y Y^T / n + lam I,         Y = X[i, :]
    r     = Y (y - alpha) / n - lam w[i]
    v     = Gamma^{-1} r                          (ridge candidate, Cholesky)
    w[i] <- S(w[i] + v, lam1 / diag(Gamma))       (soft-threshold)

CA-PBCD(s) reproduces the classical proximal iterates for every grouping of
the index stream, ragged tail included, and ``lam1 = 0`` runs the ridge sweep
itself, so it equals the primal ridge solve bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from .engine import (RowMajorOperand, SolveResult, SolverContracts,
                     SolverPlan, _BoundPrimal, _ShardedLayout, _fit_residual,
                     _objective_from_alpha, _sol_err, register_formulation,
                     register_solver, s_step_solve)
from .sampling import overlap_matrix
from .subproblem import (block_forward_substitution,
                         block_forward_substitution_prox, soft_threshold)


@dataclasses.dataclass(frozen=True)
class _BoundProximal(_BoundPrimal):
    """The primal's hooks with the prox-aware sweep and the elastic-net
    metrics: the l1 term has no gradient in the residual, it only reshapes
    each block's applied step."""
    lam1: float = 0.0

    def inner_sweep(self, A, base, s_k, b, flat, carry, overlap=None):
        if not self.lam1:
            # lam1 = 0 runs the ridge sweep itself: S(w + v, 0) - w == v
            # holds only in exact arithmetic.  lam1 is a python float here,
            # in a batched tenant too, so a batched lam1 = 0 tenant takes
            # this branch as its single solve does.
            return block_forward_substitution(A, base, s_k, b)
        # diag(A) = ||x_i||^2 / n + lam: reg * I at s_k = 1, reg * O (unit
        # diagonal) otherwise.
        tau = self.lam1 / torch.diagonal(A)
        if overlap is None:     # the engine builds O only at s_k > 1
            overlap = overlap_matrix(flat).to(A.dtype)
        return block_forward_substitution_prox(
            A, base, s_k, b, w0=carry[0][flat.long()], tau=tau,
            overlap=overlap)

    def metrics(self, carry):
        w, alpha = carry
        m = {"objective": _objective_from_alpha(alpha, w, self.y, self.lam)
             + self.lam1 * torch.sum(torch.abs(w)),
             "nnz": torch.sum(w != 0).to(w.dtype),
             "residual": _fit_residual(alpha, self.y)}
        if self.w_ref is not None:
            m["sol_err"] = _sol_err(w, self.w_ref)
        return m


@dataclasses.dataclass(frozen=True)
class ProximalElasticNet(_ShardedLayout):
    """CA-PBCD: samples features like the primal, in its 1D block-column
    layout.  ``lam1`` is formulation state; the registry's instance
    (lam1 = 0) is the one the batched engine binds, with each tenant's
    ``lam1`` from ``TenantBatch.coeffs``."""
    lam1: float = 0.0
    name: ClassVar[str] = "proximal"
    operand_layout: ClassVar[str] = "rows"
    tenant_batched: ClassVar[bool] = True

    def __post_init__(self):
        # A negative lam1 turns the soft-threshold into an inflation step
        # that diverges instead of sparsifying.
        if not self.lam1 >= 0:
            raise ValueError(f"lam1={self.lam1!r} must be >= 0")

    def contracts(self):
        # The soft-threshold runs on the replicated reduced packet, so the
        # l1 term adds no communication: the primal's contract, checked at
        # lam1 > 0 so that the prox sweep is the path that runs.  lam1 rides
        # TenantBatch.coeffs in a batched solve.
        return SolverContracts(sweep_kwargs=(("lam1", 1e-3),),
                               health_in_packet=True, tenant_batched=True)

    def sample_dim(self, d, n):
        return d

    def bind(self, X, y, lam, *, x0=None, w_ref=None):
        d, n = X.shape
        return _BoundProximal(operand=RowMajorOperand(X), y=y, lam=lam, n=n,
                              d=d, w0=x0, w_ref=w_ref, lam1=self.lam1)

    def bind_shard(self, Xl, yl, lam, *, d, n, x0=None):
        # The soft-threshold runs on the replicated reduced packet: the l1
        # term adds no communication.
        return _BoundProximal(operand=RowMajorOperand(Xl), y=yl, lam=lam,
                              n=n, d=d, w0=x0, lam1=self.lam1)


def elastic_net_objective(X: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                          lam: float, lam1: float) -> torch.Tensor:
    """f(w) = 1/(2n) ||X^T w - y||^2 + lam/2 ||w||^2 + lam1 ||w||_1."""
    n = X.shape[1]
    r = X.T @ w - y
    return (0.5 / n * (r @ r) + 0.5 * lam * (w @ w)
            + lam1 * torch.sum(torch.abs(w)))


def proximal_bcd_reference(X: torch.Tensor, y: torch.Tensor, lam: float,
                           lam1: float, b: int, iters: int, idx
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Hand-rolled classical proximal BCD (s = 1): materialised panel, dense
    solve, explicit threshold.  An oracle that shares no code with the
    engine."""
    d, n = X.shape
    w = torch.zeros((d,), dtype=X.dtype, device=X.device)
    alpha = torch.zeros((n,), dtype=X.dtype, device=X.device)
    eye = torch.eye(b, dtype=X.dtype, device=X.device)
    for h in range(iters):
        i = idx[h].long()
        Y = X[i, :]
        Gamma = Y @ Y.T / n + lam * eye
        r = Y @ (y - alpha) / n - lam * w[i]
        v = torch.linalg.solve(Gamma, r)
        dw = soft_threshold(w[i] + v, lam1 / torch.diagonal(Gamma)) - w[i]
        w = w.index_add(0, i, dw)
        alpha = alpha + Y.T @ dw
    return w, alpha


def proximal_bcd(X: torch.Tensor, y: torch.Tensor, lam: float, b: int,
                 iters: int, generator: torch.Generator | None = None, *,
                 lam1: float = 0.0, w0: torch.Tensor | None = None,
                 idx: torch.Tensor | None = None,
                 w_ref: torch.Tensor | None = None, impl: str | None = None,
                 tiles: int | None = None) -> SolveResult:
    """Classical proximal BCD: the engine at s = 1.  ``lam`` is the l2
    weight, ``lam1`` the l1 weight; ``lam1 = 0`` is :func:`~.bcd.bcd`."""
    plan = SolverPlan(b=b, s=1, impl=impl, tiles=tiles)
    return s_step_solve(ProximalElasticNet(lam1=lam1), plan, X, y, lam, iters,
                        generator, x0=w0, idx=idx, w_ref=w_ref)


def ca_proximal_bcd(X: torch.Tensor, y: torch.Tensor, lam: float, b: int,
                    s: int, iters: int,
                    generator: torch.Generator | None = None, *,
                    lam1: float = 0.0, w0: torch.Tensor | None = None,
                    idx: torch.Tensor | None = None,
                    w_ref: torch.Tensor | None = None,
                    track_cond: bool = False, impl: str | None = None,
                    tiles: int | None = None, guard: bool = False,
                    fault=None, step0: int = 0) -> SolveResult:
    """CA proximal BCD (arXiv:1712.06047): one sb x sb Gram packet per outer
    step, then ``s`` prox-thresholded block solves.  The same index stream
    as :func:`proximal_bcd` gives the same iterates in exact arithmetic.
    ``guard``, ``fault`` and ``step0`` as in :func:`~.bcd.ca_bcd`."""
    plan = SolverPlan(b=b, s=s, impl=impl, tiles=tiles, track_cond=track_cond,
                      guard=guard, fault=fault)
    return s_step_solve(ProximalElasticNet(lam1=lam1), plan, X, y, lam, iters,
                        generator, x0=w0, idx=idx, w_ref=w_ref, step0=step0)


def ca_proximal_bcd_sharded(world, X: torch.Tensor, y: torch.Tensor,
                            lam: float, b: int, s: int, iters: int,
                            generator: torch.Generator | None = None, *,
                            lam1: float = 0.0, fuse_packet: bool = True,
                            idx: torch.Tensor | None = None,
                            impl: str | None = None, tiles: int | None = None,
                            guard: bool = False, fault=None,
                            x0: torch.Tensor | None = None, step0: int = 0):
    """Distributed CA proximal BCD on ``world``
    (:class:`~repro_torch.core.world.SolverWorld`): X sharded over columns,
    ONE packet all-reduce per outer step.  Returns ``(w, alpha)``, with the
    guard telemetry as a third item when ``guard`` is set; the keywords as
    in :func:`~repro_torch.core.distributed.ca_bcd_sharded`."""
    plan = SolverPlan(b=b, s=s, impl=impl, tiles=tiles,
                      fuse_packet=fuse_packet, guard=guard, fault=fault)
    return world.solve(ProximalElasticNet(lam1=lam1), plan, X, y, lam, iters,
                       generator, idx=idx, x0=x0, step0=step0)


def ca_proximal_bcd_pipelined(world, X: torch.Tensor, y: torch.Tensor,
                              lam: float, b: int, s: int, iters: int,
                              generator: torch.Generator | None = None, *,
                              lam1: float = 0.0, fuse_packet: bool = True,
                              idx: torch.Tensor | None = None,
                              impl: str | None = None,
                              tiles: int | None = None, guard: bool = False,
                              fault=None, x0: torch.Tensor | None = None,
                              step0: int = 0):
    """:func:`ca_proximal_bcd_sharded` on the pipelined ring wire."""
    plan = SolverPlan(b=b, s=s, impl=impl, tiles=tiles,
                      fuse_packet=fuse_packet, guard=guard, fault=fault,
                      wire="ring")
    return world.solve(ProximalElasticNet(lam1=lam1), plan, X, y, lam, iters,
                       generator, idx=idx, x0=x0, step0=step0)


register_formulation(ProximalElasticNet())
register_solver("proximal", "local", ca_proximal_bcd)
register_solver("proximal", "sharded", ca_proximal_bcd_sharded)
register_solver("proximal", "pipelined", ca_proximal_bcd_pipelined)
