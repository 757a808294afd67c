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

The distributed backends run the same body on one shard per rank of a
``torch.distributed`` group (:class:`Comm`): the primal family shards X's
n axis (w replicated, alpha local), the dual its d axis (alpha replicated, w
local).  :func:`s_step_solve_sharded` inserts ONE packet all-reduce per outer
step (:func:`_packet_reduce`) and applies the ``s_k`` blocks in one deferred
update; ``SolverPlan.wire == "ring"`` turns that reduction into a two-phase
ring of point-to-point hops with the next step's Gram contracted between the
phases (:func:`_drive_pipelined`).  Every rank runs the same subproblem on
the same reduced bytes, so the replicated iterate stays identical bytes on
every rank.  :func:`s_step_solve_batched_sharded` shares one packet
reduction among T tenants.  The process world around these SPMD functions
is :class:`repro_torch.core.world.SolverWorld`.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
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
class SolverContracts:
    """The communication and memory guarantees a formulation DECLARES, which
    the contract pass (``repro_torch.analysis.contract_pass``) checks by
    running every registered ``(formulation, backend)`` solver and reading
    each rank's record of its collective calls (``Comm.counters``).  A
    formulation without a ``contracts()`` hook FAILS the sweep: declaring
    is mandatory.

    * ``sync_per_outer``: all-reduces per outer step on the sharded backend
      (1 for every paper formulation: the single packet all-reduce).
    * ``collective_kinds``: the only ``Comm`` calls allowed in a sharded
      solve at all.
    * ``local_collective_free``: a local solve makes ZERO collective calls.
    * ``operand_transpose_free``: the shard binds in X's original layout,
      no transposed or other copy of the local operand (the dual's
      guarantee).
    * ``panel_free_impls``: kernel backends that must never allocate the
      sampled ``(sb, contraction)`` panel (``impl="ref"`` gathers it by
      design, so it is not listed); checked on the card.
    * ``f64_packet``: an f64 solve moves only f64 words.
    * ``health_in_packet``: the guard's health word rides the ONE packet
      reduction, so a guarded solve makes exactly as many calls.
    * ``sweep_kwargs``: formulation fields ((key, value) pairs) the contract
      pass sets when it runs this formulation, so that formulation-specific
      code paths (the proximal soft-threshold at ``lam1 > 0``) are the ones
      checked; a tenant-batched case carries them as per-tenant coeffs.
    * ``tenant_batched``: the batched sharded solve keeps
      ``sync_per_outer`` all-reduces per outer step for every tenant count,
      with the Gram part of the payload not scaled by T.
    * ``pipelined_collective_kinds`` / ``pipelined_hops``: the pipelined
      backend's wire.  The kinds are the only calls allowed there;
      ``pipelined_hops`` is the hops per reduction as an affine law
      ``(a, c)`` meaning ``sum_i (a * P_i + c)`` over the group sizes
      (:func:`ring_hops`): ``(2, -2)`` is the two-phase ring's
      ``2 (P - 1)``.
    """
    sync_per_outer: int = 1
    collective_kinds: tuple = ("all_reduce",)
    local_collective_free: bool = True
    operand_transpose_free: bool = True
    panel_free_impls: tuple = ("cuda",)
    f64_packet: bool = True
    health_in_packet: bool = False
    sweep_kwargs: tuple = ()
    tenant_batched: bool = False
    pipelined_collective_kinds: tuple = ("hop",)
    pipelined_hops: tuple = (2, -2)


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

    ``fuse_packet`` and ``wire`` concern the distributed backends only:
    ``fuse_packet`` lays the reduced packet out as one ``sb x (sb + 1)``
    Gram||residual operand (True) or as the two operands back to back
    (False); ``wire`` is ``"psum"`` (one all-reduce per outer step) or
    ``"ring"`` (the pipelined backend's two-phase ring).
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
    fuse_packet: bool = True
    wire: str = "psum"

    def __post_init__(self):
        for name in ("b", "s"):
            check_positive_int(f"SolverPlan.{name}", getattr(self, name))
        for name in ("guard", "fuse_packet"):
            if not isinstance(getattr(self, name), bool):
                raise ValueError(f"SolverPlan.{name}={getattr(self, name)!r}"
                                 " must be a bool")
        if self.wire not in ("psum", "ring"):
            raise ValueError(
                f"SolverPlan.wire={self.wire!r} must be 'psum' or 'ring'")
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


def _by_block(op, x: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
              block: int | None = None) -> torch.Tensor:
    """``op(x, 0, idx, vals)`` (``torch.Tensor.index_add`` or
    ``index_copy``) one ``block`` of indices at a time.  A block is drawn
    without replacement, so each call sees distinct indices and acts alike
    on every device (CUDA's ``index_add`` adds a repeated index atomically,
    in no fixed order).  A sharded step's one deferred update spans s blocks
    whose indices may repeat: block by block, a repeated index is added to,
    or set, in the order of ``idx``, as the reference's scatter does, and
    every rank gets the same bytes."""
    il = idx.long()
    if block is None or block >= il.numel():
        return op(x, 0, il, vals)
    for j in range(0, il.numel(), block):
        x = op(x, 0, il[j:j + block], vals[j:j + block])
    return x


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
    update is w[idx] += dw, alpha += Y_j^T dw (Eqs. 5, 9-10).  On a column
    shard (y and alpha local, w replicated) the same expressions compute
    the shard's contribution.
    """
    operand: PacketOperand
    y: torch.Tensor
    lam: float
    n: int          # the global data-point count (the scales use it)
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

    def init_carry(self, sharded: bool = False):
        X = self.operand.array
        if sharded:
            # w replicated, alpha this shard's slice of R^n: a warm start
            # derives it as w0 @ Xl, no transpose, no gather.
            if self.w0 is None:
                return (torch.zeros((self.d,), dtype=X.dtype, device=X.device),
                        torch.zeros(self.y.shape, dtype=X.dtype,
                                    device=X.device))
            return self.w0, self.w0 @ X
        if self.w0 is None:
            return (torch.zeros((self.d,), dtype=X.dtype, device=X.device),
                    torch.zeros((self.n,), dtype=X.dtype, device=X.device))
        # a warm start's alpha, one product, no copy of X
        return self.w0, X.T @ self.w0  # contract: allow-transpose

    def packet_vector(self, carry):
        return self.y - carry[1]

    def base(self, r, carry, flat):
        return r - self.lam * carry[0][flat]              # Eq. (7)/(8) rhs

    def inner_sweep(self, A, base, s_k, b, flat, carry, overlap=None):
        return block_forward_substitution(A, base, s_k, b)

    def update(self, carry, idx, dx, pp, block=None):
        w, alpha = carry
        # index_add, never w[idx] += dx: duplicate indices accumulate
        w = _by_block(torch.Tensor.index_add, w, idx, dx, block)  # Eq. (9)
        alpha = alpha + panel_apply(self.operand, idx, dx, plan=pp)  # (5)/(10)
        return w, alpha

    def metrics(self, carry):
        w, alpha = carry
        m = {"objective": _objective_from_alpha(alpha, w, self.y, self.lam),
             "residual": _fit_residual(alpha, self.y)}
        if self.w_ref is not None:
            m["sol_err"] = _sol_err(w, self.w_ref)
        return m


def _shard(x: torch.Tensor, n_shards: int, rank: int,
           axis: int | None) -> torch.Tensor:
    """Rank ``rank``'s block of ``x`` along ``axis`` once that axis is
    zero-padded to a multiple of ``n_shards``, as its own contiguous tensor
    (a view where the block is contiguous and needs no padding); ``axis``
    None: ``x`` itself, replicated.  Zero rows and columns of X add nothing
    to a Gram, a residual or an update, and the sampler only draws indices
    of the true size, so the padding is exact."""
    if axis is None:
        return x
    size = x.shape[axis]
    per = -(-size // n_shards)
    lo, hi = min(rank * per, size), min((rank + 1) * per, size)
    part = x.narrow(axis, lo, hi - lo)
    if hi - lo == per:
        return part.contiguous()
    shape = list(x.shape)
    shape[axis] = per
    out = x.new_zeros(shape)
    out.narrow(axis, 0, hi - lo).copy_(part)
    return out


class _ShardedLayout:
    """A formulation's 1D layout on the distributed backends.
    ``shard_axes`` is (the sharded axis of X, the sharded axis of y or None
    for a replicated y): the primal family shards X's n axis (w replicated,
    alpha local), the dual its d axis (alpha replicated, w local)."""
    shard_axes = (1, 0)

    def pad_shards(self, X, y, n_shards: int, rank: int) -> tuple:
        """Rank ``rank``'s contiguous, zero-padded ``(Xl, yl)`` of
        ``n_shards`` (an operand passed as None comes back None; ``y`` may
        stack tenants in front and is cut along its last axis).  Concatenated
        over the ranks along the sharded axes, the shards are the
        reference's padded operands."""
        ax, ay = self.shard_axes
        Xl = None if X is None else _shard(X, n_shards, rank, ax)
        yl = None if y is None else _shard(
            y, n_shards, rank, None if ay is None else y.dim() - 1)
        return Xl, yl

    def dist_finalize(self, w, alpha, d: int, n: int) -> tuple:
        """The logical ``(w, alpha)`` from the gathered, padded halves
        (stacked tenants lead, in a batched solve)."""
        if self.shard_axes[0] == 1:
            return w, alpha[..., :n]
        return w[..., :d], alpha


class PrimalRidge(_ShardedLayout):
    """(CA-)BCD: samples features (rows of X); 1D block-column layout."""
    name = "primal"
    operand_layout = "rows"
    tenant_batched = True       # per-tenant y and lam; the Gram is shared

    def contracts(self):
        # Theorems 1/6: ONE packet all-reduce per outer step, nothing else
        # on the wire; the row-major operand bound in place; the health
        # word rides that all-reduce; the batched engine shares the Gram.
        return SolverContracts(health_in_packet=True, tenant_batched=True)

    def sample_dim(self, d, n):
        return d

    def bind(self, X, y, lam, *, x0=None, w_ref=None):
        d, n = X.shape
        return _BoundPrimal(operand=RowMajorOperand(X), y=y, lam=lam, n=n,
                            d=d, w0=x0, w_ref=w_ref)

    def bind_shard(self, Xl, yl, lam, *, d, n, x0=None):
        return _BoundPrimal(operand=RowMajorOperand(Xl), y=yl, lam=lam, n=n,
                            d=d, w0=x0)


# --------------------------------------------------------------------------
# Dual formulation: min_alpha lam/2 ||X alpha/(lam n)||^2 + 1/(2n) ||alpha + y||^2
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _BoundDual:
    """Algorithm 3/4 hooks on the column-major operand over X (d, n) in its
    original layout: no transposed copy of X exists in the solve.

    Packet: Theta = Y^T Y / (lam n^2) + I/n with Y = X[:, flat] plus the raw
    projection Y^T w (scale_r = 1); base assembles Eq. (17)/(18); the update
    is alpha[idx] += da, w -= Y_j da / (lam n) (Eqs. 15, 19-20).  On a row
    shard (w local, alpha and y replicated; ``X`` None) the same
    expressions compute the shard's contribution.
    """
    operand: PacketOperand
    y: torch.Tensor
    lam: float
    n: int
    X: torch.Tensor | None      # the full X, for init and metrics (local)
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
        return _scalar(self.lam * self.n, self.operand.array)

    @functools.cached_property
    def _n(self):
        return _scalar(self.n, self.operand.array)

    def init_carry(self, sharded: bool = False):
        if sharded:
            # w this shard's slice of R^d, alpha replicated; a warm start
            # derives the slice from the original (dl, n) layout.
            Xl = self.operand.array
            if self.alpha0 is None:
                return (torch.zeros((self.operand.contraction,),
                                    dtype=Xl.dtype, device=Xl.device),
                        torch.zeros((self.n,), dtype=Xl.dtype,
                                    device=Xl.device))
            return -(Xl @ self.alpha0) / self._lam_n, self.alpha0
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

    def update(self, carry, idx, dx, pp, block=None):
        w, alpha = carry
        alpha = _by_block(torch.Tensor.index_add, alpha, idx, dx,
                          block)                           # Eq. (20)
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
        r = self.X.T @ w - self.y  # contract: allow-transpose (metric)
        m = {"objective": 0.5 / n * (r @ r) + 0.5 * self.lam * (w @ w),
             # ||X^T w - alpha - y|| -> 0 at the dual optimum.
             "residual": torch.linalg.norm(r - alpha)
             / (n * (1.0 + torch.linalg.norm(self.y)))}
        if self.w_ref is not None:
            m["sol_err"] = _sol_err(w, self.w_ref)
        return m


class DualRidge(_ShardedLayout):
    """(CA-)BDCD: samples data points (columns of X) from the original
    (d, n) layout through the column-major operand; 1D block-row layout."""
    name = "dual"
    operand_layout = "cols"
    shard_axes = (0, None)
    # The Gram scale 1/(lam n^2) is per tenant: the packet stays raw and each
    # tenant scales it in _assemble_subproblem, as its single solve does.
    # lam stays a python float per tenant, so every derived constant is the
    # single solve's; no per-tenant pinning is needed.
    tenant_batched = True

    def contracts(self):
        # Theorems 2/7, plus the guarantee this formulation exists to keep:
        # the shard binds X's original (d, n) layout, never a transposed
        # copy.  The health word rides the one packet all-reduce; the raw
        # Gram is shared by the batched engine and scaled per tenant.
        return SolverContracts(health_in_packet=True, tenant_batched=True)

    def sample_dim(self, d, n):
        return n

    def bind(self, X, y, lam, *, x0=None, w_ref=None):
        return _BoundDual(operand=ColMajorOperand(X), y=y, lam=lam,
                          n=X.shape[1], X=X, alpha0=x0, w_ref=w_ref)

    def bind_shard(self, Xl, yl, lam, *, d, n, x0=None):
        # the original (dl, n) shard, gathered in place: no transpose
        return _BoundDual(operand=ColMajorOperand(Xl), y=yl, lam=lam, n=n,
                          X=None, alpha0=x0)


FORMULATIONS = {"primal": PrimalRidge(), "dual": DualRidge()}


def register_formulation(form):
    """Make ``form`` resolvable by its ``name`` (``s_step_solve("name", ...)``
    and the batched driver); returns it."""
    FORMULATIONS[form.name] = form
    return form


# --------------------------------------------------------------------------
# The communication point
# --------------------------------------------------------------------------

HEALTH_WORDS = 5    # the guard's health word (see _health_local)


class Comm:
    """One rank's handle on a ``torch.distributed`` group: the group, this
    rank's index and the group's size, the device the rank computes on, and
    counters of its own collective calls (the port counts its calls; there
    is no compiled program to read them from).

    ``staged`` is True exactly when the group is gloo and the device is a
    GPU: gloo's point-to-point calls, its all-to-all and its all-gather
    take host tensors only, so each ring hop's chunk, all-to-all and
    all-gather is copied through a host buffer (gloo's all-reduce takes the
    device tensor itself and stages it internally).  On a staged rank the
    host waits for its device before a call, as the staging does anyway, so
    that ``reduce_s`` / ``hop_s`` / ``a2a_s`` / ``gather_s`` time the wire,
    its copies and the wait for the group's slowest rank.

    The all-to-all and the all-gather (the expert-parallel MoE,
    ``models.moe``; the grid's FSDP and ZeRO-1 gathers) and the
    reduce-scatter (FSDP's gradients) are counted apart, as the kinds
    ``"all_to_all"``, ``"all_gather"`` and ``"reduce_scatter"`` of the
    summaries (``core.collectives``), which no solver declares."""

    def __init__(self, group, device):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = torch.device(device)
        self.backend = dist.get_backend(group)
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        members = dist.get_process_group_ranks(
            dist.group.WORLD if group is None else group)
        self._next = members[(self.rank + 1) % self.size]
        self._prev = members[(self.rank - 1) % self.size]
        self.reset()

    def reset(self) -> None:
        self.all_reduces = 0    # all-reduce calls (sum and max)
        self.words = 0          # elements all-reduced, summed over calls
        self.max_reduces = 0    # of those, max all-reduces
        self.max_words = 0      # elements max-reduced
        self.max_bytes = 0      # bytes max-reduced
        self.hops = 0           # ring hops (one send and one receive each)
        self.hop_words = 0      # elements sent by the hops
        self.bytes = 0          # bytes all-reduced and sent, summed
        self.hop_bytes = 0      # of those, bytes sent by the hops
        self.dtypes = set()     # dtype names the calls moved
        self.reduce_s = 0.0     # host seconds inside all-reduce calls
        self.hop_s = 0.0        # host seconds inside hops
        self.all_to_alls = 0    # all-to-all calls
        self.a2a_words = 0      # elements this rank sent by them
        self.a2a_bytes = 0      # bytes this rank sent by them
        self.a2a_s = 0.0        # host seconds inside all-to-all calls
        self.all_gathers = 0    # all-gather calls
        self.gather_words = 0   # elements this rank contributed to them
        self.gather_bytes = 0   # bytes this rank contributed to them
        self.gather_s = 0.0     # host seconds inside all-gather calls
        self.reduce_scatters = 0    # reduce-scatter calls
        self.rs_words = 0       # elements this rank contributed to them
        self.rs_bytes = 0       # bytes this rank contributed to them
        self.rs_s = 0.0         # host seconds inside reduce-scatter calls

    def counters(self) -> dict:
        """This rank's record of its calls since :meth:`reset`
        (``dtypes`` as a sorted tuple)."""
        out = {k: getattr(self, k) for k in (
            "all_reduces", "words", "max_reduces", "max_words", "max_bytes",
            "hops", "hop_words", "hop_bytes", "bytes", "reduce_s", "hop_s",
            "all_to_alls", "a2a_words", "a2a_bytes", "a2a_s", "all_gathers",
            "gather_words", "gather_bytes", "gather_s", "reduce_scatters",
            "rs_words", "rs_bytes", "rs_s", "staged", "backend", "size")}
        out["dtypes"] = tuple(sorted(self.dtypes))
        return out

    def _record(self, t: torch.Tensor) -> None:
        self.bytes += t.numel() * t.element_size()
        self.dtypes.add(str(t.dtype).removeprefix("torch."))

    def _wait_device(self) -> None:
        if self.staged:
            torch.cuda.synchronize(self.device)

    def all_reduce(self, flat: torch.Tensor, op: str = "sum"
                   ) -> torch.Tensor:
        """Reduce ``flat`` over the group in place (one collective): its
        sum, or with ``op="max"`` its elementwise maximum (flash-decoding's
        global max, ``models.layers.decode_attention_seqsharded``).  Both
        count as all-reduces; a max is also counted apart, as the kind
        ``"max"`` of the summaries (``core.collectives``), which no solver
        declares."""
        if op not in ("sum", "max"):
            raise ValueError(f"op={op!r} must be 'sum' or 'max'")
        reduce_op = (self._dist.ReduceOp.MAX if op == "max"
                     else self._dist.ReduceOp.SUM)
        self._wait_device()
        t0 = time.perf_counter()
        self._dist.all_reduce(flat, op=reduce_op, group=self.group)
        self.reduce_s += time.perf_counter() - t0
        self.all_reduces += 1
        self.words += flat.numel()
        if op == "max":
            self.max_reduces += 1
            self.max_words += flat.numel()
            self.max_bytes += flat.numel() * flat.element_size()
        self._record(flat)
        return flat

    def hop(self, send: torch.Tensor) -> torch.Tensor:
        """One ring hop: send ``send`` to the next rank and return what the
        previous rank sent (same shape and dtype)."""
        dist = self._dist
        self._wait_device()
        t0 = time.perf_counter()
        out = send.to("cpu") if self.staged else send.contiguous()
        recv = torch.empty_like(out)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, out, self._next, self.group),
            dist.P2POp(dist.irecv, recv, self._prev, self.group)])
        for req in reqs:
            req.wait()
        if self.staged:
            recv = recv.to(self.device)
        self.hop_s += time.perf_counter() - t0
        self.hops += 1
        self.hop_words += send.numel()
        self.hop_bytes += send.numel() * send.element_size()
        self._record(send)
        return recv

    def all_to_all(self, send: torch.Tensor, send_counts,
                   recv_counts) -> torch.Tensor:
        """One all-to-all of rows with uneven splits: ``send`` (N, ...)
        holds ``send_counts[q]`` rows for rank q, in rank order; returns
        the (sum(recv_counts), ...) rows the ranks sent here, rank r's
        ``recv_counts[r]`` rows in rank order.  Every rank must pass the
        counts that match its peers' (zero rows either way is fine)."""
        send_counts = [int(c) for c in send_counts]
        recv_counts = [int(c) for c in recv_counts]
        if len(send_counts) != self.size or len(recv_counts) != self.size \
                or sum(send_counts) != send.shape[0]:
            raise ValueError(
                f"all_to_all: {send.shape[0]} rows against send counts "
                f"{send_counts} and receive counts {recv_counts} on a "
                f"group of {self.size}")
        self._wait_device()
        t0 = time.perf_counter()
        out = send.to("cpu") if self.staged else send.contiguous()
        recv = out.new_empty((sum(recv_counts),) + tuple(send.shape[1:]))
        self._dist.all_to_all_single(recv, out, recv_counts, send_counts,
                                     group=self.group)
        if self.staged:
            recv = recv.to(self.device)
        self.a2a_s += time.perf_counter() - t0
        self.all_to_alls += 1
        self.a2a_words += send.numel()
        self.a2a_bytes += send.numel() * send.element_size()
        self._record(send)
        return recv

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (same shape and dtype on every rank),
        concatenated along a new leading axis in rank order: (P, ...)."""
        self._wait_device()
        t0 = time.perf_counter()
        out = t.to("cpu") if self.staged else t.contiguous()
        parts = [torch.empty_like(out) for _ in range(self.size)]
        self._dist.all_gather(parts, out, group=self.group)
        res = torch.stack(parts)
        if self.staged:
            res = res.to(self.device)
        self.gather_s += time.perf_counter() - t0
        self.all_gathers += 1
        self.gather_words += t.numel()
        self.gather_bytes += t.numel() * t.element_size()
        self._record(t)
        return res

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (P, ...) on every rank: returns the sum over the ranks of
        their ``t[rank]`` (this rank's part), one collective."""
        if t.shape[0] != self.size:
            raise ValueError(f"reduce_scatter: a leading axis of "
                             f"{t.shape[0]} on a group of {self.size}")
        self._wait_device()
        t0 = time.perf_counter()
        src = (t.to("cpu") if self.staged else t).reshape(-1)
        out = src.new_empty(src.numel() // self.size)
        # reduce_scatter_single is the newer name of reduce_scatter_tensor
        rs = getattr(self._dist, "reduce_scatter_single", None) or \
            self._dist.reduce_scatter_tensor
        rs(out, src, group=self.group)
        out = out.reshape(t.shape[1:])
        if self.staged:
            out = out.to(self.device)
        self.rs_s += time.perf_counter() - t0
        self.reduce_scatters += 1
        self.rs_words += t.numel()
        self.rs_bytes += t.numel() * t.element_size()
        self._record(t)
        return out

    def host_s(self) -> float:
        """Host seconds inside this rank's calls since :meth:`reset`."""
        return (self.reduce_s + self.hop_s + self.a2a_s + self.gather_s
                + self.rs_s)


def _split(flat: torch.Tensor, shapes: list) -> list:
    out, off = [], 0
    for shape in shapes:
        size = math.prod(shape)
        out.append(flat[off:off + size].reshape(shape))
        off += size
    return out


def all_reduce_variadic(leaves: list, comm: Comm) -> list:
    """ONE all-reduce for any list of same-dtype tensors: ravel,
    concatenate, all-reduce, split (the reference's ``psum_variadic``)."""
    shapes = [tuple(x.shape) for x in leaves]
    flat = torch.cat([x.reshape(-1) for x in leaves])
    return _split(comm.all_reduce(flat), shapes)


def ring_hops(sizes, law: tuple = SolverContracts.pipelined_hops) -> int:
    """Ring hops per reduction on the pipelined wire: the affine law
    ``sum_i (a * P_i + c)`` over the group sizes that a formulation declares
    as ``SolverContracts.pipelined_hops``.  The default ``(2, -2)`` is the
    two-phase ring's ``2 (P - 1)`` (a reduce-scatter and an all-gather of
    ``P - 1`` hops each; a group of one makes none)."""
    a, c = law
    return sum(a * p + c for p in sizes)


def _ring_reduce_scatter(flat: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Phase one of the ring: ``P - 1`` hops of one chunk each, summing
    around the ring; afterwards this rank owns the reduced chunk
    ``(rank + 1) % P``.  Each chunk is summed along one fixed chain, so the
    reduced chunks are the same bytes whichever rank owns them."""
    P, me = comm.size, comm.rank
    pad = (-flat.numel()) % P
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    buf = flat.reshape(P, -1)
    for t in range(P - 1):
        recv = comm.hop(buf[(me - t) % P])
        k = (me - t - 1) % P
        buf[k] = buf[k] + recv
    return buf


def _ring_all_gather(buf: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Phase two: circulate the reduced chunks ``P - 1`` more hops, storing
    each received chunk verbatim, so every rank ends with the same bytes."""
    P, me = comm.size, comm.rank
    for t in range(P - 1):
        buf[(me - t) % P] = comm.hop(buf[(me + 1 - t) % P])
    return buf.reshape(-1)


def ring_reduce_variadic(leaves: list, comm: Comm, overlap_fn=None) -> tuple:
    """The pipelined wire: the same variadic packet as
    :func:`all_reduce_variadic`, summed by a two-phase ring of ``2 (P - 1)``
    hops and no all-reduce.  ``overlap_fn`` (nullary) runs between the two
    phases; its result is returned beside the reduced leaves.  The chain
    order differs from the all-reduce's, so the two wires agree to rounding,
    not bit for bit."""
    shapes = [tuple(x.shape) for x in leaves]
    flat = torch.cat([x.reshape(-1) for x in leaves])
    size = flat.numel()
    extra = None
    if comm.size > 1:
        buf = _ring_reduce_scatter(flat, comm)
        if overlap_fn is not None:
            extra = overlap_fn()
        flat = _ring_all_gather(buf, comm)[:size]
    elif overlap_fn is not None:
        extra = overlap_fn()            # a group of one: no hops
    return _split(flat, shapes), extra


def _packet_leaves(G, r, fuse: bool, health) -> list:
    """The wire layout of one packet: ``G || r`` as one ``sb x (sb + 1)``
    operand (``fuse``) or ``G`` and ``r`` back to back, then the health
    word's five slots, zero without the guard.  Guarded and unguarded
    packets thus have one layout and one length: an all-reduce may sum an
    element in an order set by its offset and the buffer's length (gloo's
    ring does), and one layout is what keeps a guarded clean solve bit for
    bit the unguarded one at any group size."""
    if health is None:
        health = torch.zeros((HEALTH_WORDS,), dtype=G.dtype, device=G.device)
    if fuse:
        return [torch.cat([G, r[:, None]], dim=1), health]
    return [G, r, health]


def _packet_unpack(red: list, fuse: bool) -> tuple:
    if fuse:
        packet, h = red
        sb = packet.shape[0]
        return packet[:, :sb], packet[:, sb], h
    return tuple(red)


def _packet_reduce(G, r, comm: Comm | None, fuse: bool, health=None):
    """THE sync point: one all-reduce per outer step of the packet
    ``(G, r)`` and the health word (see :func:`_packet_leaves`).  Returns
    ``(G, r, health)``, ``health`` None when none was handed in."""
    if comm is None:
        return G, r, health
    G, r, h = _packet_unpack(
        all_reduce_variadic(_packet_leaves(G, r, fuse, health), comm), fuse)
    return G, r, (h if health is not None else None)


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
                   gstate: GuardState, step: int, n_shards: int = 1):
    """Check the health word ``h``, then solve, degrading instead of
    corrupting.  Rung one of the degradation ladder: a nonfinite packet, a
    missing shard or a bit-flip-sized magnitude SKIPS the update (dxs = 0,
    one outer step of progress lost, the carry untouched); divergence, the
    condition proxy and a breakdown of the inner sweep RESCUE it (sanitise,
    take the smallest working diagonal jitter, sweep again).

    The health word, diag(A)'s extremes and dxs's nonfinite count reach the
    host in ONE read; the verdicts are computed there in the solve's dtype
    (numpy scalars round as the device does), so a clean step adds no
    launch after that read.  On a shard ``h`` is the REDUCED word and A the
    replicated system, the same bytes on every rank, so every rank reaches
    the same verdicts; the presence entry must sum to ``n_shards``.
    Returns ``(dxs, gstate, ginfo)``."""
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
        bad_shard = bool(h3 != n_shards)    # every shard's presence
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
                step: int = 0, gstate: GuardState | None = None,
                comm: Comm | None = None):
    """ONE outer iteration: ``s_k`` inner blocks (``plan.s``, or
    ``iters % s`` for the ragged tail).  ``step`` is the outer step's global
    index, read only by the guard and the fault hooks; ``gstate`` the guard
    state.  Returns the carry after the s_k deferred updates, the guard
    state and the per-inner-iteration metrics.

    With ``comm`` (a shard of a distributed solve) the local packet and the
    health word ride ONE all-reduce, the overlap matrix is built even at
    s_k = 1 (as in the reference), and the s_k blocks are applied in one
    deferred update (``sum_j Y_j^T dx_j == Y^T dxs``) with no metric
    pass."""
    b = plan.b
    sb = s_k * b
    pp = plan.packet
    flat = idx_k.reshape(sb)
    rank = None if comm is None else comm.rank
    u = bound.packet_vector(carry)
    # The packet leaves the kernel raw (scale = 1, scale_r = 1, reg = 0); the
    # scales and the regulariser are applied in _assemble_subproblem.
    G, r = gram_packet_sampled(bound.operand, flat, u, scale=1.0,
                               scale_r=1.0, reg=0.0, plan=pp)
    if plan.fault is not None:
        G, r = plan.fault.apply_packet(G, r, step=step, rank=rank)
    h = None
    if plan.guard:
        # after the fault, so that injected damage is seen as real damage
        h = _health_local(G, r, carry, u)
        if plan.fault is not None:
            h = plan.fault.apply_health(h, step=step, rank=rank)
    if comm is not None:
        G, r, h = _packet_reduce(G, r, comm, plan.fuse_packet, h)
    O = (overlap_matrix(flat).to(G.dtype) if comm is not None or s_k > 1
         else None)
    A, base = _assemble_subproblem(bound, G, r, carry, flat, O, sb)
    if plan.guard:
        dxs, gstate, ginfo = _guarded_sweep(
            bound, plan, A, base, s_k, b, flat, carry, O, h, gstate, step,
            1 if comm is None else comm.size)
    else:
        dxs = bound.inner_sweep(A, base, s_k, b, flat, carry, O)
        ginfo = {}
    if comm is not None:
        return bound.update(carry, flat, dxs, pp, block=b), gstate, []

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


def _gram_only(operand, flat, pp):
    """The Gram half of a future outer step's packet: ``u = 0`` and
    ``scale_r = 0`` make the residual a don't-care, so this runs the fused
    packet's contraction (K1 / K3) and depends on the index stream alone,
    never on the carry: the ring contracts step k+1's Gram while step k's
    reduction is on the wire."""
    X = operand.array
    u0 = torch.zeros((operand.contraction,), dtype=X.dtype, device=X.device)
    G, _ = gram_packet_sampled(operand, flat, u0, scale=1.0, scale_r=0.0,
                               reg=0.0, plan=pp)
    return G


def _outer_step_pipelined(bound, plan: SolverPlan, s_k: int, carry, Gl,
                          flat, flat_next, comm: Comm, step: int = 0,
                          gstate: GuardState | None = None):
    """ONE outer iteration on the ring (``plan.wire == "ring"``).  ``Gl`` is
    this step's local Gram, contracted one step ahead; the residual
    direction, which depends on the carry, comes from K6 / K5
    (``panel_matvec``, the same sums as the fused packet's r).  The packet
    and the health word ride the ring, and the next step's Gram
    (``flat_next``; None for the last step) is contracted between the
    ring's phases.  Fault hooks apply where the psum backend applies them.
    Returns ``(carry, gstate, Gl_next)``."""
    b = plan.b
    sb = s_k * b
    pp = plan.packet
    u = bound.packet_vector(carry)
    r = panel_matvec(bound.operand, flat, u, scale=1.0, plan=pp)
    if plan.fault is not None:
        Gl, r = plan.fault.apply_packet(Gl, r, step=step, rank=comm.rank)
    h = None
    if plan.guard:
        h = _health_local(Gl, r, carry, u)
        if plan.fault is not None:
            h = plan.fault.apply_health(h, step=step, rank=comm.rank)
    red, Gl_next = ring_reduce_variadic(
        _packet_leaves(Gl, r, plan.fuse_packet, h), comm,
        overlap_fn=None if flat_next is None else (
            lambda: _gram_only(bound.operand, flat_next, pp)))
    G, r, h = _packet_unpack(red, plan.fuse_packet)
    O = overlap_matrix(flat).to(G.dtype)
    A, base = _assemble_subproblem(bound, G, r, carry, flat, O, sb)
    if plan.guard:
        dxs, gstate, _ = _guarded_sweep(bound, plan, A, base, s_k, b, flat,
                                        carry, O, h, gstate, step, comm.size)
    else:
        dxs = bound.inner_sweep(A, base, s_k, b, flat, carry, O)
    return bound.update(carry, flat, dxs, pp, block=b), gstate, Gl_next


def _drive_pipelined(bound, plan: SolverPlan, idx, step0: int, comm: Comm):
    """The software-pipelined outer loop (``plan.wire == "ring"``): the
    same outer / ragged split as :func:`_drive`.  A prologue contracts the
    first step's Gram; each step consumes the Gram contracted for it and
    contracts its successor's between the ring's phases.  The host loop
    knows which step is the last, so no successor is contracted for it (the
    reference's fixed-shape scan contracts and discards one).  The ragged
    tail's packet is narrower and runs its own prologue.  No history is
    kept.  Returns ``(carry, {}, gstate)``."""
    pp = plan.packet
    carry = bound.init_carry(sharded=True)
    gstate = _guard_init(bound.operand.array.dtype) if plan.guard else None
    steps = _outer_steps(idx, plan.s)
    flats = [idx_k.reshape(-1) for _, idx_k in steps]
    Gl = None
    for k, (s_k, _) in enumerate(steps):
        if Gl is None:          # prologue: the first step, or the tail's
            Gl = _gram_only(bound.operand, flats[k], pp)
        nxt = (flats[k + 1] if k + 1 < len(steps)
               and steps[k + 1][0] == s_k else None)
        carry, gstate, Gl = _outer_step_pipelined(
            bound, plan, s_k, carry, Gl, flats[k], nxt, comm,
            step=k + step0, gstate=gstate)
    return carry, {}, gstate


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


def _drive(bound, plan: SolverPlan, idx, step0: int = 0,
           comm: Comm | None = None):
    """Every outer step of :func:`_outer_steps`, outer step k under the
    global index ``k + step0`` (a segmented solve keeps its numbering).
    With ``comm`` the steps run on a shard (no history), through
    :func:`_drive_pipelined` on the ring.  Returns ``(carry, history,
    gstate)``, ``gstate`` None without guard."""
    if comm is not None and plan.wire == "ring":
        return _drive_pipelined(bound, plan, idx, step0, comm)
    X = bound.operand.array
    carry = (bound.init_carry() if comm is None
             else bound.init_carry(sharded=True))
    gstate = _guard_init(X.dtype) if plan.guard else None
    hist = []
    for k, (s_k, idx_k) in enumerate(_outer_steps(idx, plan.s)):
        carry, gstate, h = _outer_step(bound, plan, s_k, carry, idx_k,
                                       step=k + step0, gstate=gstate,
                                       comm=comm)
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
    _check_local_wire(plan)
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


def _check_local_wire(plan: SolverPlan) -> None:
    if plan.wire != "psum":
        raise ValueError(
            f"SolverPlan.wire={plan.wire!r} needs a distributed backend; "
            "the local solve has no reduction to decompose")


def s_step_solve_sharded(formulation, plan: SolverPlan, comm: Comm,
                         Xl: torch.Tensor, yl: torch.Tensor, lam: float,
                         iters: int, *, d: int, n: int, idx: torch.Tensor,
                         x0: torch.Tensor | None = None, step0: int = 0):
    """The distributed s-step solve, an SPMD function: every rank of
    ``comm``'s group calls it with its own contiguous shard ``(Xl, yl)``
    (:meth:`PrimalRidge.pad_shards`), the global ``(d, n)`` and the same
    ``idx``.
    The same driver as :func:`s_step_solve`, with ONE packet all-reduce per
    outer step (two-phase ring hops with ``plan.wire == "ring"``) and no
    metric pass.

    ``x0`` warm-starts the formulation's own replicated iterate (w for the
    primal family, alpha for the dual); the rank-local half of the carry is
    derived on the shard.  Returns this rank's ``(w, alpha)`` -- the
    replicated one whole, the other its padded slice -- and the guard
    telemetry as a third item with ``plan.guard`` (no s = 1 tail here: the
    supervisor takes that rung).  :class:`~repro_torch.core.world.
    SolverWorld` gathers and trims them."""
    form = _resolve_form(formulation)
    _check_idx(idx, iters, plan.b)
    idx = idx.to(device=Xl.device, dtype=torch.int32)
    bound = form.bind_shard(Xl, yl, lam, d=d, n=n, x0=x0)
    carry, _, gstate = _drive(bound, plan, idx, step0, comm=comm)
    if plan.guard:
        return carry[0], carry[1], _guard_metrics(gstate)
    return carry[0], carry[1]


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
                        tol: float | None, comm: Comm | None = None) -> None:
    """ONE batched outer step, in place on ``carries`` and ``active``.

    The sb x sb Gram leaves K1/K3 once, raw, and serves every tenant; its
    fused residual is a don't-care (u = 0, scale_r = 0), as in the
    reference.  The residual directions of all tenants come from one K6/K5
    launch, which sums in the packet's residual order, so each equals the r
    of the tenant's own single-solve packet.  Each active tenant then runs
    the single solve's assembly, sweep and per-block updates, one tenant
    after another: a (T, b, b) Cholesky could take another library path and
    round differently.  A retired tenant is skipped, so its carry stays
    exactly as it was.

    With ``comm`` the shared Gram and every tenant's direction ride ONE
    reduction (``sb^2 + T sb`` words, the Gram part independent of T), and
    each tenant applies its s_k blocks in one deferred update."""
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
    if comm is not None and plan.wire == "ring":
        (G0, R), _ = ring_reduce_variadic([G0, R], comm)
    elif comm is not None:
        G0, R = all_reduce_variadic([G0, R], comm)
    O = (overlap_matrix(flat).to(G0.dtype) if comm is not None or s_k > 1
         else None)
    residuals = {}
    for t, bound in enumerate(bounds):
        if not active[t]:
            continue
        carry = carries[t]
        A, base = _assemble_subproblem(bound, G0, R[t], carry, flat, O, sb)
        dxs = bound.inner_sweep(A, base, s_k, b, flat, carry, O)
        if comm is not None:
            carry = bound.update(carry, flat, dxs, pp, block=b)
        else:
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
    _check_local_wire(plan)
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


def s_step_solve_batched_sharded(formulation, plan: SolverPlan, comm: Comm,
                                 Xl: torch.Tensor, batch: TenantBatch,
                                 iters: int, *, d: int, n: int,
                                 idx: torch.Tensor) -> tuple:
    """The distributed batched solve, an SPMD function like
    :func:`s_step_solve_sharded`: ``batch.ys`` holds this rank's slices of
    the targets (the whole targets where y is replicated) and ``batch.x0s``
    the replicated warm starts.  ONE reduction per outer step serves all T
    tenants: ``H = ceil(iters / s)`` all-reduces for the whole batch.
    ``batch.tol`` is refused: a shard cannot see a tenant's residual
    without a second collective, so retire between chunks on the local
    backend.  Returns this rank's ``(ws, alphas)``, stacked (T, ...)."""
    form = _resolve_form(formulation)
    _check_batched(form, plan, batch)
    if batch.tol is not None:
        raise ValueError(
            "batched sharded solves do not support TenantBatch.tol: in-step "
            "retirement would need a second collective per outer step; "
            "retire between chunks on the local backend instead")
    _check_idx(idx, iters, plan.b)
    idx = idx.to(device=Xl.device, dtype=torch.int32)
    bounds = []
    for t in range(batch.tenants):
        x0 = None if batch.x0s is None else batch.x0s[t].clone()
        bound = form.bind_shard(Xl, batch.ys[t].clone(), batch.lams[t], d=d,
                                n=n, x0=x0)
        extra = {k: v[t] for k, v in batch.coeffs.items()}
        bounds.append(dataclasses.replace(bound, **extra) if extra else bound)
    carries = [bd.init_carry(sharded=True) for bd in bounds]
    active = [True] * batch.tenants
    for s_k, idx_k in _outer_steps(idx, plan.s):
        _outer_step_batched(bounds, plan, s_k, carries, active, idx_k, None,
                            comm=comm)
    return (torch.stack([c[0] for c in carries]),
            torch.stack([c[1] for c in carries]))


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

BACKENDS = ("local", "sharded", "pipelined")
_REGISTRY: dict[tuple[str, str], Callable] = {}


def register_solver(formulation: str, backend: str, fn: Callable) -> Callable:
    """Register a solver entry point under ``(formulation, backend)``; the
    built-in entries are registered by ``repro_torch.core.bcd``, ``.bdcd``,
    ``.distributed``, ``.proximal`` and ``.accelerated``."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    _REGISTRY[(formulation, backend)] = fn
    return fn


def get_solver(formulation: str, backend: str = "local") -> Callable:
    """Look up a solver.  ``local`` entries have the CA signature
    ``(X, y, lam, b, s, iters, generator, **kw)``; ``sharded`` and
    ``pipelined`` entries lead with the world:
    ``(world, X, y, lam, b, s, iters, generator, **kw)``."""
    if (formulation, backend) not in _REGISTRY:
        from . import accelerated, bcd, bdcd, distributed, proximal  # noqa: F401
    try:
        return _REGISTRY[(formulation, backend)]
    except KeyError:
        raise KeyError(
            f"no solver registered for ({formulation!r}, {backend!r}); "
            f"available: {sorted(_REGISTRY)}") from None


def registered_solvers() -> dict[tuple[str, str], Callable]:
    return dict(_REGISTRY)
