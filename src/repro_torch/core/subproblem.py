"""Block subproblem solves shared by the classical and CA solvers.

The paper solves each ``b x b`` subproblem by forming its Gram matrix and
factoring it with Cholesky (section 2.1).  ``solve_spd`` is that single
choke point; the CA inner loop (block forward substitution) reuses it.
"""
from __future__ import annotations

import torch


def solve_spd(A: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = rhs`` for symmetric positive definite ``A`` via Cholesky.

    A matrix that is not positive definite gives NaN, as the reference's
    jnp solve does, instead of an exception: ``cholesky_ex`` reports failure
    on the device without a host synchronisation, and the NaN flows through.
    """
    chol, info = torch.linalg.cholesky_ex(A)
    chol = torch.where(info == 0, chol, torch.full_like(chol, float("nan")))
    return torch.cholesky_solve(rhs[:, None], chol).squeeze(-1)


def block_forward_substitution(A: torch.Tensor, base: torch.Tensor, s: int,
                               b: int) -> torch.Tensor:
    """Solve the block lower-triangular sweep of CA-BCD / CA-BDCD.

    Computes ``x`` with blocks ``x_j`` (j = 0..s-1, each of size ``b``) such
    that

        A[j,j] x_j = base_j - sum_{t<j} A[j,t] x_t

    which is the unrolled recurrence (8)/(18) of the paper once the
    ``sb x sb`` Gram-plus-overlap matrix ``A`` has been formed.

    Args:
      A: ``(s*b, s*b)`` matrix ``scale * Gram + reg * Overlap``.
      base: ``(s*b,)`` right-hand side from the deferred state.
      s, b: loop-blocking parameter and block size.

    Returns:
      ``(s*b,)`` concatenated block updates ``[dx_1; ...; dx_s]``.
    """
    sb = s * b
    A4 = A.reshape(s, b, s, b)
    corr = torch.zeros((sb,), dtype=base.dtype, device=base.device)
    xs = []
    for j in range(s):
        # corr accumulates sum_t A[:, :, t_block] @ x_t over solved blocks t.
        rhs = base[j * b:(j + 1) * b] - corr[j * b:(j + 1) * b]
        xj = solve_spd(A4[j, :, j, :], rhs)
        corr = corr + (A4[:, :, j, :] @ xj).reshape(sb)
        xs.append(xj)
    return torch.cat(xs)
