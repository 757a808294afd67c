"""Conjugate gradients on the regularised normal equations -- the paper's
Krylov baseline (Table 2, Figure 1) and its ground-truth generator.

The operator is ``X (X^T v) / n + lam v`` (``kernels.gram.normal_matvec``):
two panel products per iteration, never a d x d matrix.  ``impl=None`` keeps
the plain dense products on every device, as the reference does; ``impl=
"cuda"`` routes them through kernels K2 and K6 with ``flat = arange(d)``.

The reference's ``lax.while_loop`` becomes a Python loop: its stop test
reads the squared residual norm on the host once per iteration (one device
synchronisation each).  The fixed-iteration :func:`cg_ridge_history` reads
nothing back until it returns.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.gram import normal_matvec


class CGResult(NamedTuple):
    w: torch.Tensor
    iters: int
    history: dict


def _start(X: torch.Tensor, y: torch.Tensor, lam: float,
           impl: str | None) -> tuple:
    """CG's operator, right-hand side X y / n and starting w = 0."""
    d, n = X.shape

    def matvec(v):
        return normal_matvec(X, v, lam=lam, scale=1.0 / n, impl=impl)

    w = torch.zeros((d,), dtype=X.dtype, device=X.device)
    return matvec, X @ y / n, w


def _sol_err(w: torch.Tensor, w_ref: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(w - w_ref) / torch.linalg.norm(w_ref)


def _step(matvec, w, r, p, rs):
    """One CG iteration: the new (w, r, p, r.r)."""
    Ap = matvec(p)
    a = rs / (p @ Ap)
    w = w + a * p
    r = r - a * Ap
    rs_new = r @ r
    return w, r, r + (rs_new / rs) * p, rs_new


def cg_ridge(X: torch.Tensor, y: torch.Tensor, lam: float, *,
             tol: float = 1e-15, max_iters: int = 1000,
             w_ref: torch.Tensor | None = None,
             impl: str | None = None) -> CGResult:
    """CG on ``(X X^T / n + lam I) w = X y / n`` from w = 0, until
    ``||r|| <= tol ||X y / n||`` or ``max_iters`` iterations."""
    matvec, rhs, w = _start(X, y, lam, impl)
    r, p = rhs, rhs
    rs = r @ r
    stop2 = (tol * torch.linalg.norm(rhs)) ** 2
    k = 0
    while k < max_iters and bool(rs > stop2):        # one host read each
        w, r, p, rs = _step(matvec, w, r, p, rs)
        k += 1
    hist = {} if w_ref is None else {"sol_err": _sol_err(w, w_ref)}
    return CGResult(w, k, hist)


def cg_ridge_history(X: torch.Tensor, y: torch.Tensor, lam: float,
                     iters: int, w_ref: torch.Tensor | None = None,
                     impl: str | None = None) -> CGResult:
    """Fixed-iteration CG that records, per iteration, ``res_norm``,
    ``objective`` and (with ``w_ref``) ``sol_err``, each an (iters,) tensor
    (for Figure 1)."""
    n = X.shape[1]
    matvec, rhs, w = _start(X, y, lam, impl)
    r, p = rhs, rhs
    rs = r @ r
    hist = {"res_norm": [], "objective": []}
    if w_ref is not None:
        hist["sol_err"] = []
    for _ in range(iters):
        w, r, p, rs = _step(matvec, w, r, p, rs)
        hist["res_norm"].append(torch.sqrt(rs))
        res = X.T @ w - y
        hist["objective"].append(0.5 / n * (res @ res)
                                 + 0.5 * lam * (w @ w))
        if w_ref is not None:
            hist["sol_err"].append(_sol_err(w, w_ref))
    return CGResult(w, iters, {k: torch.stack(v) for k, v in hist.items()})
