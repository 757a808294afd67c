"""Direct ridge solve used as ground truth (a Cholesky solve of the smaller
normal equations; exact at the test sizes)."""
from __future__ import annotations

import torch

from .subproblem import solve_spd


def ridge_exact(X: torch.Tensor, y: torch.Tensor, lam: float) -> torch.Tensor:
    """w_opt = argmin lam/2||w||^2 + 1/(2n)||X^T w - y||^2.

    Uses the primal normal equations when d <= n, else the dual (kernel)
    identity w = X (X^T X/n + lam I)^{-1} y / n, keeping the solve at
    min(d, n)^2 size.
    """
    d, n = X.shape
    if d <= n:
        A = X @ X.T / n + lam * torch.eye(d, dtype=X.dtype, device=X.device)
        return solve_spd(A, X @ y / n)
    A = X.T @ X / n + lam * torch.eye(n, dtype=X.dtype, device=X.device)
    return X @ solve_spd(A, y) / n
