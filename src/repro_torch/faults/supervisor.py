"""Supervised s-step solves: bounded retry and checkpointed restart.

``solve_supervised`` runs a registered ``(formulation, "local")`` solver of
the engine registry under a host-side supervision loop, the degradation
ladder's third rung (DESIGN.md section 7).  The solve is cut into SEGMENTS of
``ckpt_every`` outer steps; after each segment the formulation's own
iterate is snapshotted through :class:`~repro_torch.checkpoint.CheckpointManager`
(CRC manifest, atomic rename).  A device loss, simulated by a
``device_loss`` :class:`~repro_torch.faults.FaultPlan` and raised on the host
as :class:`DeviceLostError` at the segment that holds the injected step,
starts a bounded retry with exponential backoff: restore the newest valid
snapshot and resume from its iteration.  The warm start re-derives the rest
of the carry from the restored iterate, so the restarted solve converges to
the uninterrupted one's answer.

Segment boundaries are multiples of ``s``, so the segmented solve takes the
same outer grouping of the index stream as the uninterrupted one; the only
difference is the warm start's rounding.  Every segment runs with the guard
armed by default; the engine's own s = 1 tail (``engine._degrade_to_s1_tail``)
is rung two.

Only the local backend is ported: the sharded backend, its elastic re-plan
over the survivors and its rung-two switch wait for the distributed port.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.engine import _resolve_form, get_solver, sample_blocks


class DeviceLostError(RuntimeError):
    """A device (shard) dropped out of the solve.  ``survivors`` is the world
    size after the loss; ``at_iter`` the inner iteration the solve had
    reached when it died."""

    def __init__(self, survivors: int, at_iter: int):
        super().__init__(f"device lost at inner iteration {at_iter}; "
                         f"{survivors} device(s) surviving")
        self.survivors = survivors
        self.at_iter = at_iter


@dataclasses.dataclass
class SupervisedResult:
    w: torch.Tensor
    alpha: torch.Tensor
    metrics: dict       # segments / restarts / guard telemetry (host ints)


def solve_supervised(formulation: str, backend: str, X: torch.Tensor,
                     y: torch.Tensor, lam: float, b: int, s: int, iters: int,
                     generator: torch.Generator | None = None, *,
                     ckpt_dir: str, idx: torch.Tensor | None = None,
                     lam1: float | None = None, ckpt_every: int = 2,
                     max_restarts: int = 3, backoff: float = 0.01,
                     fault=None, guard: bool = True, impl: str | None = None,
                     keep: int = 3) -> SupervisedResult:
    """Run a registered solver under supervision (see the module docstring).

    Args:
      formulation, backend: engine-registry key (``"primal"``, ``"dual"``,
        ``"proximal"``, ``"accelerated"``; ``"local"`` only).
      ckpt_dir: snapshot directory (synchronous writes: a segment is not
        done until its snapshot is committed).
      ckpt_every: snapshot cadence in OUTER steps.
      max_restarts: bound on restarts before the loss is raised again.
      backoff: base seconds of the exponential backoff (``backoff * 2**k``).
      fault: optional :class:`~repro_torch.faults.FaultPlan`.  In-step kinds
        ride into every segment (``step0`` keeps the global outer numbering);
        ``device_loss`` is caught HERE and raised as
        :class:`DeviceLostError` when the solve reaches its outer step.
    """
    if backend != "local":
        raise ValueError(f"backend {backend!r} is not supported: the port's "
                         "distributed backend is not ported yet, so only "
                         "'local' is")
    form = _resolve_form(formulation)
    d, n = X.shape
    if idx is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or an explicit idx")
        idx = sample_blocks(generator, form.sample_dim(d, n), b, iters)
    solve = get_solver(formulation, backend)
    mgr = CheckpointManager(ckpt_dir, keep=keep, async_save=False)

    x0 = None
    i = 0                   # inner iterations completed
    segments = restarts = total_trips = 0
    resumed_from = -1
    loss_pending = fault is not None and fault.kind == "device_loss"
    loss_iter = fault.step * s if loss_pending else -1
    w = alpha = None

    while i < iters:
        seg = min(ckpt_every * s, iters - i)
        try:
            if loss_pending and i <= loss_iter < i + seg:
                loss_pending = False
                survivors = (fault.survivors if fault.survivors is not None
                             else 1)
                raise DeviceLostError(survivors, i)
            w, alpha, trips = _run_segment(
                solve, form, X, y, lam, b, s, seg, idx[i:i + seg], i // s,
                x0, fault=fault, guard=guard, impl=impl, lam1=lam1)
        except DeviceLostError:
            restarts += 1
            if restarts > max_restarts:
                raise
            time.sleep(backoff * 2 ** (restarts - 1))
            restored = mgr.restore_latest(
                like={"x0": x0} if x0 is not None else None, device=X.device)
            if restored is not None:
                state, extra, _ = restored
                x0 = state["x0"]
                i = int(extra["iters_done"])
                resumed_from = i
            else:           # no snapshot yet: a cold restart from 0
                x0, i, resumed_from = None, 0, 0
            continue
        segments += 1
        i += seg
        total_trips += trips
        x0 = w if form.operand_layout == "rows" else alpha
        mgr.save(i, {"x0": x0}, extra={"iters_done": i, "cur_s": s},
                 block=True)
    mgr.close()
    return SupervisedResult(w, alpha, {
        "segments": segments, "restarts": restarts,
        "guard_trips": total_trips, "resumed_from_iter": resumed_from,
        "final_n_shards": 1, "final_s": s})


def _run_segment(solve, form, X, y, lam, b, s, seg, seg_idx, step0, x0, *,
                 fault, guard, impl, lam1):
    """One supervised segment through the registry's solver; returns
    ``(w, alpha, trips)``, ``trips`` a host int (one read a segment)."""
    kw = {"idx": seg_idx, "guard": guard, "fault": fault, "step0": step0,
          "impl": impl}
    if lam1 is not None:
        kw["lam1"] = lam1
    if x0 is not None:
        kw["w0" if form.operand_layout == "rows" else "alpha0"] = x0
    res = solve(X, y, lam, b, s, seg, None, **kw)
    trips = int(res.metrics["guard_trips"]) if guard else 0
    return res.w, res.alpha, trips
