"""Tall-skinny QR (TSQR) baseline (paper Table 2 / Figure 1, ref. [14]) and
its Gram-routed alternative, CholeskyQR.

:func:`tsqr` is a binary reduction tree of Householder QRs over row panels:
each leaf factors its panel, sibling R factors are stacked and factored again
up the tree, log2(P) stages and a single reduction in the distributed setting
(Figure 1c's "single message").  Every QR is one batched
``torch.linalg.qr(..., mode="r")`` call per tree level; no kernel is owed.

:func:`cholqr_r` builds R from the Cholesky factor of the c x c Gram A^T A,
computed by ``kernels.gram.gram`` -- kernel K8 on a CUDA tensor.

:func:`tsqr_ridge` solves ridge through either R by the semi-normal
equations: the tall regularised operand A = [X^T / sqrt(n); sqrt(lam) I]
has A^T A = R^T R, and two triangular solves follow.  For d > n the dual
form keeps the operand tall and skinny (cost min(d, n)^2 max(d, n)).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.gram import gram

from .subproblem import cholesky_nan


def _pad_rows(A: torch.Tensor, rows: int) -> torch.Tensor:
    """A (..., m, c) with zero rows appended up to ``rows``."""
    return F.pad(A, (0, 0, 0, max(rows - A.shape[-2], 0)))


def tsqr(A: torch.Tensor, n_blocks: int = 8) -> torch.Tensor:
    """R factor of tall A (m >= c) via a binary reduction tree.

    ``n_blocks`` plays the role of P leaf processors and is rounded up to a
    power of two.  Equal, up to the signs of its rows, to
    ``torch.linalg.qr(A).R``; the signs cancel in R^T R, which is all the
    ridge solve uses.
    """
    m, c = A.shape
    nb = 1
    while nb < n_blocks:
        nb *= 2
    rows = -(-m // nb) * nb
    panels = _pad_rows(A, rows).reshape(nb, rows // nb, c)
    # Leaf panels shorter than c are padded so that each R is square.
    rs = torch.linalg.qr(_pad_rows(panels, c), mode="r").R    # (nb, c, c)
    while rs.shape[0] > 1:
        half = rs.shape[0] // 2
        stacked = torch.cat([rs[:half], rs[half:]], dim=1)    # (half, 2c, c)
        rs = torch.linalg.qr(stacked, mode="r").R
    return rs[0]


def cholqr_r(A: torch.Tensor, *, impl: str | None = None) -> torch.Tensor:
    """R factor of tall A (m >= c) by CholeskyQR: R^T R = A^T A, upper
    triangular.

    The Gram is ``gram(A^T)``; the kernel reads its operand row-major, so
    ``A^T`` must be contiguous: a view ``A = B.T`` of a contiguous B costs
    nothing, while a contiguous tall A costs one explicit copy of A^T here.
    A Gram that is not positive definite gives an all-NaN R, as the
    reference's jnp Cholesky does.
    """
    dtype = A.dtype
    G = gram(A.T.contiguous(), impl=impl)                      # c x c
    del A    # a caller that passed A inline frees it before the factor
    return cholesky_nan(G.to(dtype)).T


def ridge_operand(X: torch.Tensor, lam: float) -> torch.Tensor:
    """The transpose of :func:`tsqr_ridge`'s tall operand, contiguous:
    ``[X / sqrt(n), sqrt(lam) I_d]`` (d, n + d) for d <= n, else
    ``[X^T / sqrt(n), sqrt(lam) I_n]`` (n, d + n).  Written in place into
    one allocation; the dual branch transposes X once, here."""
    d, n = X.shape
    Z = X if d <= n else X.T                                   # (c, k)
    c, k = Z.shape
    At = X.new_empty((c, k + c))
    torch.div(Z, math.sqrt(n), out=At[:, :k])
    At[:, k:].zero_().diagonal().fill_(math.sqrt(float(lam)))
    return At


def tsqr_ridge(X: torch.Tensor, y: torch.Tensor, lam: float,
               n_blocks: int = 8, method: str = "tsqr",
               impl: str | None = None) -> torch.Tensor:
    """Ridge solve through the R factor of the regularised operand: by TSQR
    (``method="tsqr"``) or by CholeskyQR (``"cholqr"``, its Gram through K8
    on a CUDA tensor unless ``impl`` says otherwise)."""
    if method not in ("tsqr", "cholqr"):
        raise ValueError(f"unknown method {method!r}; expected tsqr|cholqr")
    d, n = X.shape
    # The tall operand is passed inline, so that cholqr_r frees it (7.82 GB
    # at real-sim) before the Cholesky factor is allocated.
    if method == "cholqr":
        R = cholqr_r(ridge_operand(X, lam).T, impl=impl)
    else:
        R = tsqr(ridge_operand(X, lam).T, n_blocks)
    # Primal: w = (A^T A)^-1 X y / n.  Dual: w = X (A^T A)^-1 y / n.
    rhs = X @ y / n if d <= n else y
    z = torch.linalg.solve_triangular(R.T, rhs[:, None], upper=False)
    z = torch.linalg.solve_triangular(R, z, upper=True)[:, 0]
    return z if d <= n else X @ z / n
