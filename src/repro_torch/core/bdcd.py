"""Dual block coordinate descent (Algorithm 3) and CA-BDCD (Algorithm 4).

Solves the dual problem

    min_alpha  lam/2 ||X alpha/(lam n)||^2 + 1/(2n) ||alpha + y||^2

with the primal iterate kept as w = -X alpha / (lam n), as thin wrappers over
the s-step engine.  The CA inner loop is block forward substitution against

    A = Y^T Y / (lam n^2) + O / n,   Y = X[:, flat],  O = overlap(flat).

The dual samples columns of X; the column-major operand reads them from the
original (d, n) layout (kernels K3 and K4 on the card), so no transposed copy
of the dataset is ever made.
"""
from __future__ import annotations

import torch

from .engine import (DualRidge, SolveResult, SolverPlan, register_solver,
                     s_step_solve)

DUAL = DualRidge()


def bdcd(X: torch.Tensor, y: torch.Tensor, lam: float, b: int, iters: int,
         generator: torch.Generator | None = None, *,
         alpha0: torch.Tensor | None = None, idx: torch.Tensor | None = None,
         w_ref: torch.Tensor | None = None, impl: str | None = None,
         tiles: int | None = None) -> SolveResult:
    """Classical BDCD, Algorithm 3: the engine at s = 1 (``b`` is b')."""
    plan = SolverPlan(b=b, s=1, impl=impl, tiles=tiles)
    return s_step_solve(DUAL, plan, X, y, lam, iters, generator, x0=alpha0,
                        idx=idx, w_ref=w_ref)


def ca_bdcd(X: torch.Tensor, y: torch.Tensor, lam: float, b: int, s: int,
            iters: int, generator: torch.Generator | None = None, *,
            alpha0: torch.Tensor | None = None,
            idx: torch.Tensor | None = None,
            w_ref: torch.Tensor | None = None, track_cond: bool = False,
            impl: str | None = None, tiles: int | None = None,
            guard: bool = False, fault=None, step0: int = 0) -> SolveResult:
    """CA-BDCD, Algorithm 4: the engine at s > 1; same index stream as
    :func:`bdcd` gives the same iterates in exact arithmetic.  ``guard``,
    ``fault`` and ``step0`` as in :func:`~.bcd.ca_bcd`."""
    plan = SolverPlan(b=b, s=s, impl=impl, tiles=tiles, track_cond=track_cond,
                      guard=guard, fault=fault)
    return s_step_solve(DUAL, plan, X, y, lam, iters, generator, x0=alpha0,
                        idx=idx, w_ref=w_ref, step0=step0)


# ca_bdcd at s=1 is classical bdcd, so it is the canonical registry entry.
register_solver("dual", "local", ca_bdcd)
