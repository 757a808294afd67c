"""Primal block coordinate descent (Algorithm 1) and CA-BCD (Algorithm 2) for

    min_w  lam/2 ||w||^2 + 1/(2n) ||X^T w - y||^2,      X in R^{d x n},

as thin wrappers over the s-step engine: classical BCD is the engine at
``s = 1``, CA-BCD(s) the same loop at ``s > 1``.  Both consume the same index
stream, so CA-BCD(s) reproduces BCD's iterates in exact arithmetic.

The CA inner loop is a block forward substitution against

    A = (1/n) Y Y^T + lam * O,     Y = X[flat, :],  O = overlap(flat),

whose packet comes straight from (X, flat) through the row-major operand
(kernel K1 on the card) and whose deferred update ``alpha += Y^T dw`` uses
the same pair (kernel K2).
"""
from __future__ import annotations

import torch

from .engine import (PrimalRidge, SolveResult, SolverPlan, register_solver,
                     s_step_solve)

PRIMAL = PrimalRidge()


def objective(X: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
              lam: float) -> torch.Tensor:
    """f(X, w, y) = 1/(2n) ||X^T w - y||^2 + lam/2 ||w||^2."""
    n = X.shape[1]
    r = X.T @ w - y
    return 0.5 / n * (r @ r) + 0.5 * lam * (w @ w)


def bcd(X: torch.Tensor, y: torch.Tensor, lam: float, b: int, iters: int,
        generator: torch.Generator | None = None, *,
        w0: torch.Tensor | None = None, idx: torch.Tensor | None = None,
        w_ref: torch.Tensor | None = None, impl: str | None = None,
        tiles: int | None = None) -> SolveResult:
    """Classical BCD, Algorithm 1 (residual form): the engine at s = 1."""
    plan = SolverPlan(b=b, s=1, impl=impl, tiles=tiles)
    return s_step_solve(PRIMAL, plan, X, y, lam, iters, generator, x0=w0,
                        idx=idx, w_ref=w_ref)


def ca_bcd(X: torch.Tensor, y: torch.Tensor, lam: float, b: int, s: int,
           iters: int, generator: torch.Generator | None = None, *,
           w0: torch.Tensor | None = None, idx: torch.Tensor | None = None,
           w_ref: torch.Tensor | None = None, track_cond: bool = False,
           impl: str | None = None, tiles: int | None = None,
           guard: bool = False, fault=None, step0: int = 0) -> SolveResult:
    """CA-BCD, Algorithm 2: the engine at s > 1.  ``iters`` counts inner
    iterations; a non-multiple of ``s`` runs a ragged final outer step.
    ``guard`` arms the health guard and the degradation ladder, ``fault``
    injects a test-only :class:`repro_torch.faults.FaultPlan`, and ``step0``
    offsets the outer-step numbering of a segmented solve."""
    plan = SolverPlan(b=b, s=s, impl=impl, tiles=tiles, track_cond=track_cond,
                      guard=guard, fault=fault)
    return s_step_solve(PRIMAL, plan, X, y, lam, iters, generator, x0=w0,
                        idx=idx, w_ref=w_ref, step0=step0)


# ca_bcd at s=1 is classical bcd, so it is the canonical registry entry.
register_solver("primal", "local", ca_bcd)
