"""The s-step engine behind (CA-)BCD and (CA-)BDCD, single device.

One outer step samples ``s`` coordinate blocks, builds ONE ``sb x sb`` Gram
packet ``(G, r)`` straight from ``(X, flat)``, assembles the subproblem
``A = scale * G + reg * O``, solves ``s`` blocks by forward substitution and
applies the deferred updates from ``(X, flat)`` again.  What distinguishes
the primal from the dual -- which axis of X is sampled, the packet's scales,
the right-hand side, which iterate the update touches -- lives in a
formulation (:class:`PrimalRidge`, :class:`DualRidge`) bound to the problem
data; ``s = 1`` is the classical algorithm, not a separate loop.

This is the port of the reference engine's local backend.  ``lax.scan``
becomes a Python loop; eager PyTorch fuses nothing, so no counterpart of the
reference's optimisation barriers is needed, but the reference's order of
operations is kept: the packet leaves the kernel raw and is scaled and
regularised in :func:`_assemble_subproblem`, and true divisions stay
divisions (by a device tensor, so that no backend turns them into a
reciprocal multiply).  ``iters`` need not be a multiple of ``s``: a ragged
final outer step of ``iters % s`` blocks runs through the same body.

With ``SolverPlan.guard`` the engine checks a health word every outer
step and degrades instead of corrupting (DESIGN.md section 7): a nonfinite,
lost or bit-flipped packet skips the step's update, a divergent or
ill-conditioned one is rescued with a diagonal jitter, and a trip at
``s > 1`` finishes the solve at ``s = 1``.  The host reads the health word
and two statistics of the step in one read a step and decides there.
``SolverPlan.fault`` injects a test-only fault
(:class:`repro_torch.faults.FaultPlan`) into the raw packet.  Without guard
and fault the path runs no extra operation.

The tenant-batched driver (:func:`s_step_solve_batched`) runs T solves over
one X and one index stream: one shared Gram packet per outer step, one
residual-direction launch for all tenants, and then each tenant's assembly,
sweep and updates through the very calls its single solve makes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.kernels.gram import (ColMajorOperand, PacketOperand,
                                      PacketPlan, RowMajorOperand,
                                      gram_packet_sampled, panel_apply,
                                      panel_matvec)
from repro_torch.kernels.gram.ops import check_positive_int

from .sampling import overlap_matrix, sample_blocks
from .subproblem import block_forward_substitution, choose_jitter


class SolveResult(NamedTuple):
    w: torch.Tensor        # (d,) primal iterate
    alpha: torch.Tensor    # (n,) auxiliary iterate (X^T w primal; dual vector)
    history: dict          # metric name -> (iters,) tensor, per inner iteration
    metrics: dict = {}     # end-of-solve scalars (guard / recovery telemetry)


@dataclasses.dataclass(frozen=True)
class SolverPlan:
    """Everything the engine needs besides the problem data.

    ``b`` is the block size (b' for the dual), ``s`` the loop-blocking
    parameter (s = 1 is the classical algorithm).  ``impl`` selects the
    Gram-packet backend and ``tiles`` its contraction chunk ``bk``, collapsed
    into one :class:`~repro_torch.kernels.gram.PacketPlan`.  ``track_cond`` records
    cond(scale * G + reg * I) per outer step in the history.  ``tenants``
    pins the tenant count of a batched solve (``None``: whatever the
    :class:`TenantBatch` holds); a batch of another width is refused.

    ``guard`` arms the per-outer-step health guard and the degradation
    ladder.  ``guard_boost`` is the envelope margin of the divergence and
    magnitude guards (trip when the tracked quantity exceeds ``boost`` times
    its running floor); ``guard_cond_max`` caps the Gram-diagonal ratio
    (``None``: ``0.1 / eps`` of the dtype).  ``fault`` is a test-only
    :class:`repro_torch.faults.FaultPlan` (anything with ``apply_packet`` and
    ``apply_health``) injected into every outer step.
    """
    b: int
    s: int = 1
    impl: str | None = None
    tiles: int | None = None
    track_cond: bool = False
    guard: bool = False
    guard_boost: float = 1e4
    guard_cond_max: float | None = None
    fault: object | None = None
    tenants: int | None = None

    def __post_init__(self):
        for name in ("b", "s"):
            check_positive_int(f"SolverPlan.{name}", getattr(self, name))
        if not isinstance(self.guard, bool):
            raise ValueError(f"SolverPlan.guard={self.guard!r} must be a bool")
        if not self.guard_boost > 1:
            raise ValueError(
                f"SolverPlan.guard_boost={self.guard_boost!r} must be > 1")
        if self.guard_cond_max is not None and not self.guard_cond_max > 1:
            raise ValueError(
                f"SolverPlan.guard_cond_max={self.guard_cond_max!r} must be "
                "> 1 (or None for the dtype default)")
        if self.fault is not None and not (
                hasattr(self.fault, "apply_packet")
                and hasattr(self.fault, "apply_health")):
            raise ValueError(
                f"SolverPlan.fault={self.fault!r} must provide apply_packet "
                "and apply_health (see repro_torch.faults.FaultPlan)")
        if self.tenants is not None:
            check_positive_int("SolverPlan.tenants", self.tenants)
        self.packet  # PacketPlan validates impl and the tile values

    @property
    def packet(self) -> PacketPlan:
        return PacketPlan(impl=self.impl, bk=self.tiles)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A python number as a 0-d tensor on ``like``'s device.  Dividing by it
    is a true per-element division on every backend; dividing by a python
    number is not (CUDA multiplies by its reciprocal)."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


# --------------------------------------------------------------------------
# Shared metric helpers
# --------------------------------------------------------------------------

def _objective_from_alpha(alpha, w, y, lam):
    # alpha == X^T w is maintained by the residual-form recurrence, so the
    # objective costs O(n + d) per iteration instead of O(dn).
    n = alpha.shape[0]
    r = alpha - y
    return 0.5 / n * (r @ r) + 0.5 * lam * (w @ w)


def _sol_err(w, w_ref):
    return torch.linalg.norm(w - w_ref) / torch.linalg.norm(w_ref)


def _fit_residual(alpha, y):
    # ||alpha - y|| / (1 + ||y||): a relative data-fit proxy, not a
    # stationarity certificate (the ridge optimum has a nonzero fit residual).
    return torch.linalg.norm(alpha - y) / (1.0 + torch.linalg.norm(y))


# --------------------------------------------------------------------------
# Primal formulation: min_w lam/2 ||w||^2 + 1/(2n) ||X^T w - y||^2
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _BoundPrimal:
    """Algorithm 1/2 hooks on the row-major X (d, n).

    Packet: Gamma = Y Y^T / n + lam I with Y = X[flat, :] and the residual
    Y (y - alpha) / n of the Eq. (7)/(8) rhs; base subtracts lam w; the
    update is w[idx] += dw, alpha += Y_j^T dw (Eqs. 5, 9-10).
    """
    operand: PacketOperand
    y: torch.Tensor
    lam: float
    n: int
    d: int
    w0: torch.Tensor | None = None
    w_ref: torch.Tensor | None = None

    @property
    def scale(self):
        return 1.0 / self.n

    @property
    def scale_r(self):
        return None         # defaults to scale

    @property
    def reg(self):
        return self.lam

    def init_carry(self):
        X = self.operand.array
        if self.w0 is None:
            return (torch.zeros((self.d,), dtype=X.dtype, device=X.device),
                    torch.zeros((self.n,), dtype=X.dtype, device=X.device))
        return self.w0, X.T @ self.w0

    def packet_vector(self, carry):
        return self.y - carry[1]

    def base(self, r, carry, flat):
        return r - self.lam * carry[0][flat]              # Eq. (7)/(8) rhs

    def inner_sweep(self, A, base, s_k, b, flat, carry, overlap=None):
        return block_forward_substitution(A, base, s_k, b)

    def update(self, carry, idx, dx, pp):
        w, alpha = carry
        # index_add, never w[idx] += dx: duplicate indices must accumulate.
        w = w.index_add(0, idx.long(), dx)                  # Eq. (9)
        alpha = alpha + panel_apply(self.operand, idx, dx, plan=pp)  # (5)/(10)
        return w, alpha

    def metrics(self, carry):
        w, alpha = carry
        m = {"objective": _objective_from_alpha(alpha, w, self.y, self.lam),
             "residual": _fit_residual(alpha, self.y)}
        if self.w_ref is not None:
            m["sol_err"] = _sol_err(w, self.w_ref)
        return m


class PrimalRidge:
    """(CA-)BCD: samples features (rows of X)."""
    name = "primal"
    operand_layout = "rows"
    tenant_batched = True       # per-tenant y and lam; the Gram is shared

    def sample_dim(self, d, n):
        return d

    def bind(self, X, y, lam, *, x0=None, w_ref=None):
        d, n = X.shape
        return _BoundPrimal(operand=RowMajorOperand(X), y=y, lam=lam, n=n,
                            d=d, w0=x0, w_ref=w_ref)


# --------------------------------------------------------------------------
# Dual formulation: min_alpha lam/2 ||X alpha/(lam n)||^2 + 1/(2n) ||alpha + y||^2
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _BoundDual:
    """Algorithm 3/4 hooks on the column-major operand over X (d, n) in its
    original layout: no transposed copy of X exists in the solve.

    Packet: Theta = Y^T Y / (lam n^2) + I/n with Y = X[:, flat] plus the raw
    projection Y^T w (scale_r = 1); base assembles Eq. (17)/(18); the update
    is alpha[idx] += da, w -= Y_j da / (lam n) (Eqs. 15, 19-20).
    """
    operand: PacketOperand
    y: torch.Tensor
    lam: float
    n: int
    X: torch.Tensor
    alpha0: torch.Tensor | None = None
    w_ref: torch.Tensor | None = None

    @property
    def scale(self):
        return 1.0 / (self.lam * self.n * self.n)

    @property
    def scale_r(self):
        return 1.0

    @property
    def reg(self):
        return 1.0 / self.n

    @functools.cached_property
    def _lam_n(self):
        """The Eq. (15)/(19) divisor lam*n, for true divisions."""
        return _scalar(self.lam * self.n, self.X)

    @functools.cached_property
    def _n(self):
        return _scalar(self.n, self.X)

    def init_carry(self):
        X = self.X
        alpha = (torch.zeros((self.n,), dtype=X.dtype, device=X.device)
                 if self.alpha0 is None else self.alpha0)
        q = X @ alpha
        return -q / self._lam_n, alpha

    def packet_vector(self, carry):
        return carry[0]

    def base(self, u, carry, flat):
        w, alpha = carry
        num = u - alpha[flat] - self.y[flat]
        return num / self._n                               # Eq. (17)/(18)

    def inner_sweep(self, A, base, s_k, b, flat, carry, overlap=None):
        return block_forward_substitution(A, base, s_k, b)

    def update(self, carry, idx, dx, pp):
        w, alpha = carry
        alpha = alpha.index_add(0, idx.long(), dx)          # Eq. (20)
        # Eq. (15)/(19): w -= X[:, idx] @ dx / (lam n), gather-apply, then
        # divide, then subtract.
        ap = panel_apply(self.operand, idx, dx, plan=pp)
        w = w - ap / self._lam_n
        return w, alpha

    def metrics(self, carry):
        # The primal objective at the dual-generated primal iterate w.  X^T w
        # is one pass over X per inner iteration, as in the reference.
        w, alpha = carry
        n = self.n
        r = self.X.T @ w - self.y
        m = {"objective": 0.5 / n * (r @ r) + 0.5 * self.lam * (w @ w),
             # ||X^T w - alpha - y|| -> 0 at the dual optimum.
             "residual": torch.linalg.norm(r - alpha)
             / (n * (1.0 + torch.linalg.norm(self.y)))}
        if self.w_ref is not None:
            m["sol_err"] = _sol_err(w, self.w_ref)
        return m


class DualRidge:
    """(CA-)BDCD: samples data points (columns of X) from the original
    (d, n) layout through the column-major operand."""
    name = "dual"
    operand_layout = "cols"
    # The Gram scale 1/(lam n^2) is per tenant: the packet stays raw and each
    # tenant scales it in _assemble_subproblem, as its single solve does.
    # lam stays a python float per tenant, so every derived constant is the
    # single solve's; no per-tenant pinning is needed.
    tenant_batched = True

    def sample_dim(self, d, n):
        return n

    def bind(self, X, y, lam, *, x0=None, w_ref=None):
        return _BoundDual(operand=ColMajorOperand(X), y=y, lam=lam,
                          n=X.shape[1], X=X, alpha0=x0, w_ref=w_ref)


FORMULATIONS = {"primal": PrimalRidge(), "dual": DualRidge()}


def register_formulation(form):
    """Make ``form`` resolvable by its ``name`` (``s_step_solve("name", ...)``
    and the batched driver); returns it."""
    FORMULATIONS[form.name] = form
    return form


# --------------------------------------------------------------------------
# Health guards (DESIGN.md section 7)
# --------------------------------------------------------------------------

# Guard-trip reason bits (``SolveResult.metrics["guard_first_reason"]``).
GUARD_NONFINITE = 1    # NaN/Inf in the packet or the solver carry
GUARD_SHARD_LOSS = 2   # a shard's presence flag missing from the packet
GUARD_DIVERGENCE = 4   # packet-vector norm blew past its running envelope
GUARD_MAGNITUDE = 8    # packet magnitude blew past its envelope (bit flips)
GUARD_COND = 16        # Gram-diagonal condition proxy tripped
GUARD_BREAKDOWN = 32   # the inner sweep itself produced nonfinite updates


class GuardState(NamedTuple):
    """Guard telemetry carried across outer steps, on the host.  The
    envelopes are running minima of ``1 + ||u||^2`` and ``1 + max |G|`` (the
    +1 keeps an iterate growing from exactly zero, the dual's cold w, from
    arming a zero envelope), so the divergence and magnitude guards need
    one clean outer step to arm.  The envelopes and the jitter are numpy
    scalars of the solve's dtype, so that every verdict rounds as the
    device would."""
    env_r: np.floating      # running floor of 1 + packet-vector norm^2
    env_g: np.floating      # running floor of 1 + max |G|
    trips: int              # count of tripped outer steps
    first_trip: int         # outer index of the first trip (-1: clean)
    first_reason: int       # GUARD_* bits at the first trip
    max_jitter: np.floating  # largest diagonal jitter of a rescue


def _np_dtype(dtype: torch.dtype):
    return np.dtype(str(dtype).removeprefix("torch.")).type


def _guard_init(dtype: torch.dtype) -> GuardState:
    f = _np_dtype(dtype)
    return GuardState(f(np.inf), f(np.inf), 0, -1, 0, f(0))


def _guard_metrics(gstate: GuardState) -> dict:
    return {"guard_trips": gstate.trips,
            "guard_first_trip": gstate.first_trip,
            "guard_first_reason": gstate.first_reason,
            "guard_max_jitter": float(gstate.max_jitter)}


def _nonfinite(x, dtype):
    """The count of x's NaN and Inf entries, in ``dtype``: x - x is exactly
    0 where x is finite and NaN elsewhere.  Three launches, where
    ``torch.isfinite`` alone takes four."""
    return (x - x).ne(0).sum(dtype=dtype)


def _health_local(G, r, carry, u):
    """The health word of one packet, five entries in G's dtype: [nonfinite
    count in (G, r); nonfinite count over every carry leaf; packet-vector
    squared norm; presence (1); max |G|].  All are sums, so that a
    reduction over shards would give the global verdicts."""
    dtype = G.dtype
    nonfinite = _nonfinite(G, dtype) + _nonfinite(r, dtype)
    counts = [_nonfinite(leaf, dtype) for leaf in carry]
    carry_bad = sum(counts[1:], counts[0])
    r2 = torch.sum(u * u)
    present = torch.ones((), dtype=dtype, device=G.device)
    gmax = torch.max(torch.abs(G))
    return torch.stack([nonfinite, carry_bad, r2, present, gmax])


def _guarded_sweep(bound, plan, A, base, s_k, b, flat, carry, O, h,
                   gstate: GuardState, step: int):
    """Check the health word ``h``, then solve, degrading instead of
    corrupting.  Rung one of the degradation ladder: a nonfinite packet, a
    missing shard or a bit-flip-sized magnitude SKIPS the update (dxs = 0,
    one outer step of progress lost, the carry untouched); divergence, the
    condition proxy and a breakdown of the inner sweep RESCUE it (sanitise,
    take the smallest working diagonal jitter, sweep again).

    The health word, diag(A)'s extremes and dxs's nonfinite count reach the
    host in ONE read; the verdicts are computed there in the solve's dtype
    (numpy scalars round as the device does), so a clean step adds no
    launch after that read.  Returns ``(dxs, gstate, ginfo)``."""
    f = _np_dtype(A.dtype)
    dxs = bound.inner_sweep(A, base, s_k, b, flat, carry, O)
    dmin, dmax = torch.aminmax(torch.diagonal(A))
    stats = torch.cat([h, torch.stack([dmin, dmax,
                                       _nonfinite(dxs, A.dtype)])])
    h0, h1, h2, h3, h4, dmin, dmax, bad_dxs = (f(v) for v in stats.tolist())
    with np.errstate(all="ignore"):      # inf and NaN are verdicts here
        boost = f(plan.guard_boost)
        r_now, g_now = f(1) + h2, f(1) + h4
        cond_max = f(plan.guard_cond_max if plan.guard_cond_max is not None
                      else 0.1 / np.finfo(f).eps)
        bad_nonfinite = bool(h0 + h1 > 0)
        bad_shard = bool(h3 != 1)           # the one shard's presence
        bad_div = bool(r_now > boost * gstate.env_r)
        bad_mag = bool(g_now > boost * gstate.env_g)
        bad_cond = bool((dmin <= 0) | (
            dmax / np.maximum(dmin, np.finfo(f).tiny) > cond_max))
    bad_solve = bool(bad_dxs > 0)
    skip = bad_nonfinite or bad_shard or bad_mag
    rescue = (bad_div or bad_cond or bad_solve) and not skip
    jitter = f(0)
    if rescue:
        As = torch.nan_to_num(A, nan=0.0, posinf=0.0, neginf=0.0)
        bs = torch.nan_to_num(base, nan=0.0, posinf=0.0, neginf=0.0)
        jit, _ = choose_jitter(As)
        eye = torch.eye(s_k * b, dtype=A.dtype, device=A.device)
        dj = bound.inner_sweep(As + jit * eye, bs, s_k, b, flat, carry, O)
        dxs = torch.where(torch.isfinite(dj), dj, torch.zeros_like(dj))
        jitter = f(jit.item())
    if skip:
        dxs = torch.zeros_like(dxs)
    tripped = skip or rescue
    reason = (GUARD_NONFINITE * bad_nonfinite + GUARD_SHARD_LOSS * bad_shard
              + GUARD_DIVERGENCE * bad_div + GUARD_MAGNITUDE * bad_mag
              + GUARD_COND * bad_cond + GUARD_BREAKDOWN * bad_solve)
    first = gstate.first_trip < 0 and tripped
    gstate = GuardState(
        env_r=min(gstate.env_r, r_now) if np.isfinite(r_now) else gstate.env_r,
        env_g=min(gstate.env_g, g_now) if np.isfinite(g_now) else gstate.env_g,
        trips=gstate.trips + tripped,
        first_trip=step if first else gstate.first_trip,
        first_reason=reason if first else gstate.first_reason,
        max_jitter=max(gstate.max_jitter, jitter))
    ginfo = {"guard_tripped": float(tripped), "guard_reason": float(reason),
             "guard_jitter": float(jitter)}
    return dxs, gstate, ginfo


# --------------------------------------------------------------------------
# The one s-step body and the loop over outer steps
# --------------------------------------------------------------------------

def _assemble_subproblem(bound, G0, r, carry, flat, O, sb: int):
    """``A = scale * G0 + reg * (I or O)`` and the formulation rhs, from the
    RAW packet.  ``O`` is the duplicate-index overlap matrix (diagonal
    exactly 1), or ``None`` for an s_k = 1 step, whose only regularised
    entries are the diagonal.  reg*O is a fill, not a multiply: O is 0/1."""
    mask = (torch.eye(sb, dtype=torch.bool, device=G0.device) if O is None
            else O != 0)
    regO = torch.zeros_like(G0).masked_fill_(mask, bound.reg)
    A = bound.scale * G0 + regO
    scale_r = bound.scale if bound.scale_r is None else bound.scale_r
    return A, bound.base(scale_r * r, carry, flat)


def _outer_step(bound, plan: SolverPlan, s_k: int, carry, idx_k,
                step: int = 0, gstate: GuardState | None = None):
    """ONE outer iteration: ``s_k`` inner blocks (``plan.s``, or
    ``iters % s`` for the ragged tail).  ``step`` is the outer step's global
    index, read only by the guard and the fault hooks; ``gstate`` the guard
    state.  Returns the carry after the s_k deferred updates, the guard
    state and the per-inner-iteration metrics."""
    b = plan.b
    sb = s_k * b
    pp = plan.packet
    flat = idx_k.reshape(sb)
    u = bound.packet_vector(carry)
    # The packet leaves the kernel raw (scale = 1, scale_r = 1, reg = 0); the
    # scales and the regulariser are applied in _assemble_subproblem.
    G, r = gram_packet_sampled(bound.operand, flat, u, scale=1.0,
                               scale_r=1.0, reg=0.0, plan=pp)
    if plan.fault is not None:
        G, r = plan.fault.apply_packet(G, r, step=step)
    O = overlap_matrix(flat).to(G.dtype) if s_k > 1 else None
    A, base = _assemble_subproblem(bound, G, r, carry, flat, O, sb)
    if plan.guard:
        # after the fault, so that injected damage is seen as real damage
        h = _health_local(G, r, carry, u)
        if plan.fault is not None:
            h = plan.fault.apply_health(h, step=step)
        dxs, gstate, ginfo = _guarded_sweep(bound, plan, A, base, s_k, b,
                                            flat, carry, O, h, gstate, step)
    else:
        dxs = bound.inner_sweep(A, base, s_k, b, flat, carry, O)
        ginfo = {}

    # Reconstruct the per-inner-iteration trajectory: one deferred update
    # (and one metric evaluation) per block.
    hist = []
    for j in range(s_k):
        carry = bound.update(carry, flat[j * b:(j + 1) * b],
                             dxs[j * b:(j + 1) * b], pp)
        hist.append(bound.metrics(carry) | ginfo)
    if plan.track_cond:
        # cond of the scaled packet with its ridge diagonal (A is not it: its
        # off-diagonal overlap entries shift the spectrum at s > 1).
        Greg = bound.scale * G + bound.reg * torch.eye(
            sb, dtype=G.dtype, device=G.device)
        cond = torch.linalg.cond(Greg)
        for h in hist:
            h["gram_cond"] = cond
    return carry, gstate, hist


def _resolve_form(formulation):
    """Resolve a formulation name (or pass an instance through), importing
    the sibling modules that register themselves on first use."""
    if not isinstance(formulation, str):
        return formulation
    if formulation not in FORMULATIONS:
        from . import accelerated, proximal  # noqa: F401
    try:
        return FORMULATIONS[formulation]
    except KeyError:
        raise KeyError(f"unknown formulation {formulation!r}; "
                       f"available: {sorted(FORMULATIONS)}") from None


def _check_idx(idx, iters: int, b: int) -> None:
    """An explicit index stream must cover exactly the requested iterations."""
    if tuple(idx.shape) != (iters, b):
        raise ValueError(f"idx shape {tuple(idx.shape)} does not match "
                         f"(iters, b) = ({iters}, {b})")


def _outer_steps(idx, s: int) -> list:
    """``(s_k, idx_k)`` of each outer step: ``iters // s`` full steps plus,
    when ``iters % s != 0``, one ragged step of ``iters % s`` blocks."""
    iters = idx.shape[0]
    steps = [(s, idx[k:k + s]) for k in range(0, iters - s + 1, s)]
    if iters % s:
        steps.append((iters % s, idx[iters - iters % s:]))
    return steps


def _drive(bound, plan: SolverPlan, idx, step0: int = 0):
    """Every outer step of :func:`_outer_steps`, outer step k under the
    global index ``k + step0`` (a segmented solve keeps its numbering).
    Returns ``(carry, history, gstate)``, ``gstate`` None without guard."""
    X = bound.operand.array
    carry = bound.init_carry()
    gstate = _guard_init(X.dtype) if plan.guard else None
    hist = []
    for k, (s_k, idx_k) in enumerate(_outer_steps(idx, plan.s)):
        carry, gstate, h = _outer_step(bound, plan, s_k, carry, idx_k,
                                       step=k + step0, gstate=gstate)
        hist.extend(h)

    def series(values):
        # the guard's telemetry is host numbers, every metric a 0-d tensor
        if isinstance(values[0], torch.Tensor):
            return torch.stack(values)
        return torch.tensor(values, dtype=X.dtype, device=X.device)
    history = ({key: series([h[key] for h in hist]) for key in hist[0]}
               if hist else {})
    return carry, history, gstate


def s_step_solve(formulation, plan: SolverPlan, X: torch.Tensor,
                 y: torch.Tensor, lam: float, iters: int,
                 generator: torch.Generator | None = None, *,
                 x0: torch.Tensor | None = None,
                 idx: torch.Tensor | None = None,
                 w_ref: torch.Tensor | None = None,
                 step0: int = 0) -> SolveResult:
    """Single-device s-step solve on X's device.  ``plan.s == 1`` IS the
    classical variant; larger ``s`` gives the same iterates in exact
    arithmetic.

    ``x0`` warm-starts the formulation's own iterate (w primal, alpha dual).
    ``idx`` (int (iters, b)) overrides the index stream, which is otherwise
    drawn from ``generator``; the classical and CA runs that share it give
    identical iterates in exact arithmetic.  ``step0`` offsets the outer-step
    numbering that the guard and the fault hooks see (segmented solves).

    With ``plan.guard`` the result's ``metrics`` hold the guard telemetry,
    and a trip at ``s > 1`` takes rung two of the degradation ladder
    (:func:`_degrade_to_s1_tail`).
    """
    form = _resolve_form(formulation)
    d, n = X.shape
    if idx is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or an explicit idx")
        idx = sample_blocks(generator, form.sample_dim(d, n), plan.b, iters)
    else:
        _check_idx(idx, iters, plan.b)
    idx = idx.to(device=X.device, dtype=torch.int32)
    bound = form.bind(X, y, lam, x0=x0, w_ref=w_ref)
    # A formulation may carry more than (w, alpha): the accelerated
    # velocity rides at carry[2].
    carry, history, gstate = _drive(bound, plan, idx, step0)
    metrics = {}
    if plan.guard:
        metrics = _guard_metrics(gstate)
        if plan.s > 1 and gstate.first_trip >= 0:
            return _degrade_to_s1_tail(form, plan, X, y, lam, idx,
                                       gstate.first_trip, step0, x0, w_ref,
                                       metrics)
    return SolveResult(carry[0], carry[1], history, metrics)


def _degrade_to_s1_tail(form, plan, X, y, lam, idx, first, step0, x0, w_ref,
                        metrics):
    """Rung two of the degradation ladder: a guard tripped at outer step
    ``first`` of an ``s > 1`` solve.  Replay the clean prefix at ``s`` (the
    same index stream over the same data gives the same clean steps),
    warm-start from its iterate and run the remaining iterations at
    ``s = 1``, so that a further breakdown poisons one iteration's update
    instead of ``s``.  The tail keeps the guard and the fault, numbered from
    ``first``, so that the fault fires again inside it."""
    n_clean = (first - step0) * plan.s
    hists = []
    if n_clean > 0:
        pre = s_step_solve(form, plan, X, y, lam, n_clean, x0=x0,
                           idx=idx[:n_clean], w_ref=w_ref, step0=step0)
        hists.append(pre.history)
        x0 = pre.w if form.operand_layout == "rows" else pre.alpha
    tail = s_step_solve(form, dataclasses.replace(plan, s=1), X, y, lam,
                        idx.shape[0] - n_clean, x0=x0, idx=idx[n_clean:],
                        w_ref=w_ref, step0=first)
    hists.append(tail.history)
    history = {k: torch.cat([h[k] for h in hists]) for k in tail.history}
    metrics = dict(metrics)
    metrics["s1_tail_from_outer"] = first
    metrics["s1_tail_from_iter"] = n_clean
    metrics["s1_tail_trips"] = tail.metrics["guard_trips"]
    metrics["guard_max_jitter"] = max(metrics["guard_max_jitter"],
                                      tail.metrics["guard_max_jitter"])
    return SolveResult(tail.w, tail.alpha, history, metrics)


# --------------------------------------------------------------------------
# Tenant-batched engine: T solves over one X and one index stream
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantBatch:
    """T tenant solves sharing one X and one block-index stream.

    * ``ys`` (T, n): per-tenant targets, on X's device.
    * ``lams``: T per-tenant l2 weights, kept as python floats, so that each
      tenant binds exactly as its single solve does.
    * ``coeffs``: per-tenant fields of the bound formulation, name -> T
      python floats (the proximal ``lam1``).
    * ``x0s`` (T, dim): optional warm starts of the formulation's own iterate.
    * ``tol``: optional early retirement: after an outer step, a tenant whose
      ``residual`` metric is ``tol`` or below takes no further updates.
    """
    ys: torch.Tensor
    lams: tuple
    coeffs: dict = dataclasses.field(default_factory=dict)
    x0s: torch.Tensor | None = None
    tol: float | None = None

    def __post_init__(self):
        if self.ys.dim() != 2:
            raise ValueError(f"TenantBatch.ys must be (tenants, n), got "
                             f"{tuple(self.ys.shape)}")
        T = self.ys.shape[0]
        object.__setattr__(self, "lams", _floats("lams", self.lams, T))
        object.__setattr__(self, "coeffs", {
            k: _floats(f"coeffs[{k!r}]", v, T)
            for k, v in self.coeffs.items()})
        if self.x0s is not None and (self.x0s.dim() != 2
                                     or self.x0s.shape[0] != T):
            raise ValueError(f"TenantBatch.x0s must be ({T}, dim), got "
                             f"{tuple(self.x0s.shape)}")
        if self.tol is not None and not self.tol > 0:
            raise ValueError(f"TenantBatch.tol={self.tol!r} must be > 0")

    @property
    def tenants(self) -> int:
        return self.ys.shape[0]


def _floats(name: str, values, T: int) -> tuple:
    """T per-tenant numbers as python floats (a tensor is read back to the
    host once)."""
    if isinstance(values, torch.Tensor):
        values = values.tolist()
    values = tuple(float(v) for v in values)
    if len(values) != T:
        raise ValueError(f"TenantBatch.{name} has {len(values)} entries, "
                         f"expected one per tenant ({T})")
    return values


class BatchedSolveResult(NamedTuple):
    ws: torch.Tensor       # (T, d) per-tenant primal iterates
    alphas: torch.Tensor   # (T, n) per-tenant auxiliary iterates
    active: torch.Tensor   # (T,) bool: False once a tenant retired
    metrics: dict = {}


def _bind_tenants(form, X, batch: TenantBatch, with_x0: bool) -> list:
    """One bound formulation per tenant.  Each tenant's vectors are copied
    out of the batch, so that they are laid out as a single solve's."""
    bounds = []
    for t in range(batch.tenants):
        x0 = (batch.x0s[t].clone() if with_x0 and batch.x0s is not None
              else None)
        bound = form.bind(X, batch.ys[t].clone(), batch.lams[t], x0=x0)
        extra = {k: v[t] for k, v in batch.coeffs.items()}
        bounds.append(dataclasses.replace(bound, **extra) if extra else bound)
    return bounds


def _outer_step_batched(bounds: list, plan: SolverPlan, s_k: int,
                        carries: list, active: list, idx_k,
                        tol: float | None) -> None:
    """ONE batched outer step, in place on ``carries`` and ``active``.

    The sb x sb Gram leaves K1/K3 once, raw, and serves every tenant; its
    fused residual is a don't-care (u = 0, scale_r = 0), as in the
    reference.  The residual directions of all tenants come from one K6/K5
    launch, which sums in the packet's residual order, so each equals the r
    of the tenant's own single-solve packet.  Each active tenant then runs
    the single solve's assembly, sweep and per-block updates, one tenant
    after another: a (T, b, b) Cholesky could take another library path and
    round differently.  A retired tenant is skipped, so its carry stays
    exactly as it was."""
    b = plan.b
    sb = s_k * b
    pp = plan.packet
    flat = idx_k.reshape(sb)
    operand = bounds[0].operand
    X = operand.array
    u0 = torch.zeros((operand.contraction,), dtype=X.dtype, device=X.device)
    G0, _ = gram_packet_sampled(operand, flat, u0, scale=1.0, scale_r=0.0,
                                reg=0.0, plan=pp)
    U = torch.stack([bd.packet_vector(c) for bd, c in zip(bounds, carries)])
    R = panel_matvec(operand, flat, U, scale=1.0, plan=pp)
    O = overlap_matrix(flat).to(G0.dtype) if s_k > 1 else None
    residuals = {}
    for t, bound in enumerate(bounds):
        if not active[t]:
            continue
        carry = carries[t]
        A, base = _assemble_subproblem(bound, G0, R[t], carry, flat, O, sb)
        dxs = bound.inner_sweep(A, base, s_k, b, flat, carry, O)
        for j in range(s_k):
            carry = bound.update(carry, flat[j * b:(j + 1) * b],
                                 dxs[j * b:(j + 1) * b], pp)
        carries[t] = carry
        if tol is not None:
            residuals[t] = bound.metrics(carry)["residual"]
    if residuals:                        # one wait for the device per step
        values = torch.stack(list(residuals.values())).tolist()
        for t, r in zip(residuals, values):
            active[t] = r > tol          # NaN retires, as in the reference


def _check_batched(form, plan: SolverPlan, batch: TenantBatch) -> None:
    if not getattr(form, "tenant_batched", False):
        raise ValueError(f"formulation {form.name!r} does not support the "
                         "tenant-batched engine (tenant_batched is not set)")
    for knob in ("guard", "track_cond"):
        if getattr(plan, knob):
            raise ValueError(f"batched solves do not support "
                             f"SolverPlan.{knob}")
    if plan.fault is not None:
        raise ValueError("batched solves do not support SolverPlan.fault")
    if plan.tenants is not None and plan.tenants != batch.tenants:
        raise ValueError(f"SolverPlan.tenants={plan.tenants} != batch width "
                         f"{batch.tenants}")


def _host_mask(active0, T: int) -> list:
    if active0 is None:
        return [True] * T
    if isinstance(active0, torch.Tensor):
        active0 = active0.tolist()
    mask = [bool(a) for a in active0]
    if len(mask) != T:
        raise ValueError(f"active0 has {len(mask)} entries, expected {T}")
    return mask


def s_step_solve_batched(formulation, plan: SolverPlan, X: torch.Tensor,
                         batch: TenantBatch, iters: int,
                         generator: torch.Generator | None = None, *,
                         idx: torch.Tensor | None = None, carry0=None,
                         active0=None) -> BatchedSolveResult:
    """T tenant solves on X's device over one index stream, the Gram packet
    shared.  Each tenant's iterates equal its single :func:`s_step_solve`
    over the same stream bit for bit, on the plain versions and through the
    kernels.

    ``carry0`` (a ``(ws, alphas)`` pair) and ``active0`` (T bools) resume an
    earlier batched solve; a tenant that is not active takes no update.
    With ``batch.tol`` set, tenants retire once their ``residual`` reaches
    it (checked after each outer step; ``result.active`` says who is still
    running).  No per-iteration history is kept.
    """
    form = _resolve_form(formulation)
    _check_batched(form, plan, batch)
    d, n = X.shape
    if idx is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or an explicit idx")
        idx = sample_blocks(generator, form.sample_dim(d, n), plan.b, iters)
    else:
        _check_idx(idx, iters, plan.b)
    idx = idx.to(device=X.device, dtype=torch.int32)
    T = batch.tenants
    bounds = _bind_tenants(form, X, batch, with_x0=carry0 is None)
    if carry0 is None:
        carries = [bd.init_carry() for bd in bounds]
    else:
        ws0, alphas0 = carry0
        if tuple(ws0.shape) != (T, d) or tuple(alphas0.shape) != (T, n):
            raise ValueError(f"carry0 shapes {tuple(ws0.shape)}, "
                             f"{tuple(alphas0.shape)} != ({T}, {d}), "
                             f"({T}, {n})")
        carries = [(ws0[t].clone(), alphas0[t].clone()) for t in range(T)]
    active = _host_mask(active0, T)

    for s_k, idx_k in _outer_steps(idx, plan.s):
        if not any(active):
            break
        _outer_step_batched(bounds, plan, s_k, carries, active, idx_k,
                            batch.tol)
    return BatchedSolveResult(
        torch.stack([c[0] for c in carries]),
        torch.stack([c[1] for c in carries]),
        torch.tensor(active, dtype=torch.bool, device=X.device), {})


def batched_residuals(formulation, X: torch.Tensor, batch: TenantBatch,
                      carries) -> torch.Tensor:
    """(T,) ``residual`` metric of each tenant's carry ``(ws, alphas)``,
    computed as its single solve computes it."""
    form = _resolve_form(formulation)
    ws, alphas = carries
    bounds = _bind_tenants(form, X, batch, with_x0=False)
    return torch.stack([
        bd.metrics((ws[t].clone(), alphas[t].clone()))["residual"]
        for t, bd in enumerate(bounds)])


# --------------------------------------------------------------------------
# Solver registry, keyed on (formulation, backend)
# --------------------------------------------------------------------------

BACKENDS = ("local",)
_REGISTRY: dict[tuple[str, str], Callable] = {}


def register_solver(formulation: str, backend: str, fn: Callable) -> Callable:
    """Register a solver entry point under ``(formulation, backend)``; the
    built-in entries are registered by ``repro_torch.core.bcd``, ``.bdcd``,
    ``.proximal`` and ``.accelerated``."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    _REGISTRY[(formulation, backend)] = fn
    return fn


def get_solver(formulation: str, backend: str = "local") -> Callable:
    """Look up a solver.  ``local`` entries have the CA signature
    ``(X, y, lam, b, s, iters, generator, **kw)``."""
    if (formulation, backend) not in _REGISTRY:
        from . import accelerated, bcd, bdcd, proximal  # noqa: F401
    try:
        return _REGISTRY[(formulation, backend)]
    except KeyError:
        raise KeyError(
            f"no solver registered for ({formulation!r}, {backend!r}); "
            f"available: {sorted(_REGISTRY)}") from None


def registered_solvers() -> dict[tuple[str, str], Callable]:
    return dict(_REGISTRY)
