"""Block subproblem solves shared by the classical and CA solvers.

The paper solves each ``b x b`` subproblem by forming its Gram matrix and
factoring it with Cholesky (section 2.1).  ``solve_spd`` is that single
choke point; the CA inner loop (block forward substitution) reuses it, and
so does the proximal sweep, which soft-thresholds each block's candidate.
:func:`solve_spd_jittered` hardens it for singular or corrupted blocks: the
guarded engine's rescue picks its diagonal jitter with
:func:`choose_jitter`.
"""
from __future__ import annotations

import torch


def cholesky_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of symmetric positive definite ``A``.

    A matrix that is not positive definite gives an all-NaN factor, as the
    reference's jnp Cholesky does, instead of an exception: ``cholesky_ex``
    reports failure on the device without a host synchronisation, and the
    NaN flows through.
    """
    chol, info = torch.linalg.cholesky_ex(A)
    return chol.masked_fill_((info != 0)[..., None, None], float("nan"))


def solve_spd(A: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = rhs`` for symmetric positive definite ``A`` via Cholesky
    (NaN where ``A`` is not positive definite; :func:`cholesky_nan`)."""
    return torch.cholesky_solve(rhs[:, None], cholesky_nan(A)).squeeze(-1)


# Relative diagonal jitter, escalated (DESIGN.md section 7).  Level 0 probes
# the unmodified matrix, so a healthy block is not perturbed; the ladder ends
# at max|diag(A)| itself, past which the block carries no usable curvature.
JITTER_LEVELS = (0.0, 1e-12, 1e-9, 1e-6, 1e-3, 1.0)


def choose_jitter(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest relative diagonal jitter that makes ``A`` Cholesky-clean.

    Factors ``A + lev * scale * I`` for every level of :data:`JITTER_LEVELS`
    in one batched ``cholesky_ex`` (``scale = max(|diag(A)|, 1)``) and
    returns ``(jitter, ok)``: the smallest absolute jitter whose factor is
    finite with a strictly positive diagonal, and whether any level was.
    With no clean level the jitter is the last level's.  Nothing is read
    back to the host.
    """
    sb = A.shape[0]
    scale = torch.clamp_min(torch.abs(torch.diagonal(A)).max(), 1.0)
    jitters = scale * torch.tensor(JITTER_LEVELS, dtype=A.dtype,
                                   device=A.device)
    eye = torch.eye(sb, dtype=A.dtype, device=A.device)
    chol, info = torch.linalg.cholesky_ex(A + jitters[:, None, None] * eye)
    good = ((info == 0) & torch.isfinite(chol).all(dim=(1, 2))
            & (torch.diagonal(chol, dim1=1, dim2=2) > 0).all(dim=1))
    ok = good.any()
    # argmax gives the first clean level; with none, the last level
    level = torch.where(ok, torch.argmax(good.to(torch.int8)),
                        len(JITTER_LEVELS) - 1)
    return jitters[level], ok


def solve_spd_jittered(A: torch.Tensor, rhs: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NaN-free SPD solve: :func:`solve_spd` hardened for singular or
    corrupted ``A``.

    Non-finite entries become 0, the diagonal jitter is escalated through
    :func:`choose_jitter`, and a solution that is still not finite becomes
    zeros.  Returns ``(x, jitter, ok)``; ``ok`` is False when no level gave a
    clean factor or the solution was not finite (the zero update is then
    the degraded step: skip, don't corrupt).  A rank-deficient block of
    duplicate sampled indices at ``lam = 0`` is the canonical case: plain
    :func:`solve_spd` returns NaN there.
    """
    A = torch.nan_to_num(A, nan=0.0, posinf=0.0, neginf=0.0)
    rhs = torch.nan_to_num(rhs, nan=0.0, posinf=0.0, neginf=0.0)
    jitter, ok = choose_jitter(A)
    x = solve_spd(A + jitter * torch.eye(A.shape[0], dtype=A.dtype,
                                         device=A.device), rhs)
    finite = torch.isfinite(x).all()
    return torch.where(finite, x, torch.zeros_like(x)), jitter, ok & finite


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


def soft_threshold(u: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Elementwise ``S(u, tau) = sign(u) max(|u| - tau, 0)``, the proximal
    operator of ``tau ||.||_1``.  ``S(u, 0) == u`` for finite floats."""
    return torch.sign(u) * torch.clamp_min(torch.abs(u) - tau, 0)


def block_forward_substitution_prox(A: torch.Tensor, base: torch.Tensor,
                                    s: int, b: int, *, w0: torch.Tensor,
                                    tau: torch.Tensor,
                                    overlap: torch.Tensor) -> torch.Tensor:
    """The prox-aware block sweep of CA proximal BCD (arXiv:1712.06047).

    Per block ``j`` it runs the recurrence of
    :func:`block_forward_substitution` for the candidate ridge step ``v_j``,
    then soft-thresholds the candidate iterate:

        w_j^cur = w0_j + sum_{t<j} overlap[j,t] x_t        (duplicate indices)
        x_j     = S(w_j^cur + v_j, tau_j) - w_j^cur

    The applied update ``x_j`` feeds the correction sums, so the s-step
    iterates match the classical (s = 1) proximal schedule for any grouping
    of the index stream.

    Args:
      A: ``(s*b, s*b)`` matrix ``scale * Gram + reg * Overlap``.
      base: ``(s*b,)`` right-hand side at the outer-step start.
      s, b: loop-blocking parameter and block size.
      w0: ``(s*b,)`` values of the sampled coordinates at the outer start.
      tau: ``(s*b,)`` per-coordinate thresholds (``lam1 / diag(A)``).
      overlap: ``(s*b, s*b)`` duplicate-index matrix, so a coordinate drawn
        again in a later block sees its updated value.

    Returns:
      ``(s*b,)`` concatenated applied updates ``[x_1; ...; x_s]``.
    """
    sb = s * b
    A4 = A.reshape(s, b, s, b)
    O4 = overlap.reshape(s, b, s, b)
    corr = torch.zeros((sb,), dtype=base.dtype, device=base.device)
    wcorr = torch.zeros_like(corr)
    xs = []
    for j in range(s):
        blk = slice(j * b, (j + 1) * b)
        vj = solve_spd(A4[j, :, j, :], base[blk] - corr[blk])
        wj = w0[blk] + wcorr[blk]
        xj = soft_threshold(wj + vj, tau[blk]) - wj
        corr = corr + (A4[:, :, j, :] @ xj).reshape(sb)
        wcorr = wcorr + (O4[:, :, j, :] @ xj).reshape(sb)
        xs.append(xj)
    return torch.cat(xs)
