"""Public ops for the Gram packet: knob resolution and backend dispatch.

* ``gram_packet(A, u)`` / ``gram(A)`` -- the packet, and the Gram alone, on
  an operand A (m, K) that is already materialised (a gathered panel,
  CholeskyQR's regularised operand): kernels K7 / K8.
* ``gram_packet_sampled(X, flat, u)`` -- the panel-free packet
  ``(G, r) = (scale * Y Y^T + reg * I, scale_r * Y u)`` for the operand's
  sampled panel ``Y``.  ``X`` is a PacketOperand or a raw (d, n) tensor,
  which means row-major: ``Y = X[flat, :]``.
* ``panel_apply(X, flat, v)`` -- ``out = scale * Y^T v``, the deferred
  vector updates (``alpha += Y^T dw`` primal, ``w -= Y da`` dual).
* ``panel_matvec(X, flat, t)`` -- ``out = scale * Y t``, the residual
  direction, for one vector t or a (T, C) stack of tenant vectors.  It sums
  in the packet's residual order, so the chunk ``bk`` (a plan's too) must be
  the packet's for the two to agree bit for bit.
* ``normal_matvec(X, v)`` -- ``(scale * X X^T + lam I) v``, CG's operator.

Backends: ``"ref"`` (the plain PyTorch versions of ``ref.py``, on any
device) and ``"cuda"`` (the hand-written kernels, CUDA tensors only).
``impl=None`` resolves from the operand's device: a CUDA tensor takes the
kernels, a CPU tensor the plain versions.  ``impl="cuda"`` on a CPU tensor
raises.  ``normal_matvec`` is the exception: see its docstring.

Callers that issue many packet calls with the same knobs (the engine) carry
one :class:`PacketPlan` and pass it as ``plan=``; explicitly passed knobs win
over the plan's.
"""
from __future__ import annotations

import dataclasses
import operator

import torch

from . import ref
from .gram_kernel import gram_dense, gram_packet_dense
from .operands import as_operand
from .sampled_kernel import panel_apply_rows, panel_matvec_rows

IMPLS = ("ref", "cuda")


@dataclasses.dataclass(frozen=True)
class PacketPlan:
    """One bundle of kernel-dispatch knobs for a sequence of packet calls.

    ``impl`` selects the backend (``None`` resolves per device); ``bk`` pins
    the packet kernels' contraction chunk (``None`` consults
    ``tuning.pick_tiles``; the G tile edge is fixed at ``tuning.TILE``).
    Knobs are validated at construction, so a typo fails before the first
    call.
    """
    impl: str | None = None
    bk: int | None = None

    def __post_init__(self):
        if self.impl is not None:
            _check_impl(self.impl)
        _check_tile("bk", self.bk)


def check_positive_int(name: str, v) -> None:
    """Ints and numpy integers >= 1; bools and floats are rejected."""
    try:
        iv = operator.index(v)
    except TypeError:
        iv = None
    if isinstance(v, bool) or iv is None or iv < 1:
        raise ValueError(f"{name}={v!r} must be a positive int")


def _check_tile(name: str, v) -> None:
    # 0 is an error, not "unset": only None defers to the plan / tuning pick.
    if v is not None:
        check_positive_int(f"kernel tile {name}", v)


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(
            f"unknown gram impl {impl!r}; expected one of {IMPLS}")


def _with_plan(plan: PacketPlan | None, impl, bk) -> tuple:
    """Explicit knobs win; only None defers to the plan's."""
    _check_tile("bk", bk)
    if plan is not None:
        impl = impl if impl is not None else plan.impl
        bk = bk if bk is not None else plan.bk
    return impl, bk


def _resolve(plan: PacketPlan | None, impl, bk, device: torch.device
             ) -> tuple[str, int | None]:
    impl, bk = _with_plan(plan, impl, bk)
    if impl is None:
        impl = "cuda" if device.type == "cuda" else "ref"
    _check_impl(impl)
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors; the operand is on "
                         f"{device}")
    return impl, bk


def gram_packet(A: torch.Tensor, u: torch.Tensor, *, scale: float = 1.0,
                reg: float = 0.0, scale_r: float | None = None,
                impl: str | None = None, bk: int | None = None,
                plan: PacketPlan | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused (G, r) = (scale * A A^T + reg * I, scale_r * A u) on a
    materialised A (m, K), u (K,); ``scale_r`` defaults to ``scale``.  The
    kernel (K7) reads A in place: a CUDA A must be contiguous."""
    impl, bk = _resolve(plan, impl, bk, A.device)
    if impl == "ref":
        return ref.gram_packet_ref(A, u, scale, reg, scale_r)
    return gram_packet_dense(A, u, scale=scale, reg=reg, scale_r=scale_r,
                             bk=bk)


def gram(A: torch.Tensor, *, scale: float = 1.0, reg: float = 0.0,
         impl: str | None = None, bk: int | None = None,
         plan: PacketPlan | None = None) -> torch.Tensor:
    """G = scale * A A^T + reg * I on a materialised A (m, K), through the
    residual-free kernel (K8): no u is fed, computed or written."""
    impl, bk = _resolve(plan, impl, bk, A.device)
    if impl == "ref":
        return ref.gram_ref(A, scale, reg)
    return gram_dense(A, scale=scale, reg=reg, bk=bk)


def gram_packet_sampled(X, flat: torch.Tensor, u: torch.Tensor, *,
                        scale: float = 1.0, reg: float = 0.0,
                        scale_r: float | None = None, impl: str | None = None,
                        bk: int | None = None, plan: PacketPlan | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Panel-free packet for the operand's sampled panel; ``flat`` (m,)
    integer indices (duplicates allowed), ``u`` of the operand's contraction
    length."""
    op = as_operand(X)
    impl, bk = _resolve(plan, impl, bk, op.array.device)
    return op.packet(flat, u, scale=scale, reg=reg, scale_r=scale_r,
                     impl=impl, bk=bk)


def panel_apply(X, flat: torch.Tensor, v: torch.Tensor, *,
                scale: float = 1.0, impl: str | None = None,
                plan: PacketPlan | None = None) -> torch.Tensor:
    """out = scale * Y^T v for the operand's sampled panel; the output length
    is the operand's contraction dimension."""
    op = as_operand(X)
    impl, _ = _resolve(plan, impl, None, op.array.device)
    return op.apply(flat, v, scale=scale, impl=impl)


def panel_matvec(X, flat: torch.Tensor, t: torch.Tensor, *,
                 scale: float = 1.0, impl: str | None = None,
                 bk: int | None = None, plan: PacketPlan | None = None
                 ) -> torch.Tensor:
    """out = scale * Y t for the operand's sampled panel: t (C,) -> (m,),
    t (T, C) -> (T, m), C the operand's contraction length."""
    op = as_operand(X)
    impl, bk = _resolve(plan, impl, bk, op.array.device)
    return op.matvec(flat, t, scale=scale, impl=impl, bk=bk)


def normal_matvec(X: torch.Tensor, v: torch.Tensor, *, lam: float = 0.0,
                  scale: float = 1.0, impl: str | None = None,
                  bk: int | None = None, plan: PacketPlan | None = None
                  ) -> torch.Tensor:
    """(scale * X X^T + lam I) v for X (d, n), v (d,): CG's normal-equations
    operator (``core/krylov.py``), never a d x d matrix.

    Unlike the other ops, ``impl=None`` (and ``"ref"``) stays on the plain
    dense product ``X @ (X.T @ v) * scale + lam * v`` on every device, as
    the reference leaves it to XLA outside any kernel: two large
    matrix-vector products that cuBLAS already runs at the card's memory
    rate.  That is the baseline's default, not a fallback.  The kernel route
    is opt-in with ``impl="cuda"``: K2 (``X^T v`` as ``panel_apply_rows``
    with ``flat = arange(d)``) then K6 (``X t`` as ``panel_matvec_rows``),
    each with its wrapper's index check.  It calls the wrappers directly, so
    on a CPU tensor they run their plain versions, which is how the CPU
    tests reach this route.
    """
    impl, bk = _with_plan(plan, impl, bk)
    impl = impl or "ref"
    _check_impl(impl)
    if impl == "ref":
        return X @ (X.T @ v) * scale + lam * v
    rows = torch.arange(X.shape[0], dtype=torch.int32, device=X.device)
    t = panel_apply_rows(X, rows, v)                               # X^T v
    out = panel_matvec_rows(X, rows, t.to(X.dtype), scale=scale, bk=bk)
    return out + lam * v
