"""Public ops for the Gram packet: knob resolution and backend dispatch.

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

Backends: ``"ref"`` (the plain PyTorch versions of ``ref.py``, on any
device) and ``"cuda"`` (the hand-written kernels, CUDA tensors only).
``impl=None`` resolves from the operand's device: a CUDA tensor takes the
kernels, a CPU tensor the plain versions.  ``impl="cuda"`` on a CPU tensor
raises.

Callers that issue many packet calls with the same knobs (the engine) carry
one :class:`PacketPlan` and pass it as ``plan=``; explicitly passed knobs win
over the plan's.
"""
from __future__ import annotations

import dataclasses
import operator

import torch

from .operands import as_operand

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


def _resolve(plan: PacketPlan | None, impl, bk, device: torch.device
             ) -> tuple[str, int | None]:
    _check_tile("bk", bk)
    if plan is not None:
        impl = impl if impl is not None else plan.impl
        bk = bk if bk is not None else plan.bk
    if impl is None:
        impl = "cuda" if device.type == "cuda" else "ref"
    _check_impl(impl)
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors; the operand is on "
                         f"{device}")
    return impl, bk


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
