"""Supervised s-step solves: bounded retry and checkpointed elastic
restart.

``solve_supervised`` runs a registered ``(formulation, backend)`` solver of
the engine registry under a host-side supervision loop, the degradation
ladder's third rung (DESIGN.md section 7).  The solve is cut into SEGMENTS
of ``ckpt_every`` outer steps; after each segment the formulation's own
logical iterate (w for the primal family, alpha for the dual; replicated on
the distributed backends) is snapshotted through
:class:`~repro_torch.checkpoint.CheckpointManager` (CRC manifest, atomic
rename).  A device loss, simulated by a ``device_loss``
:class:`~repro_torch.faults.FaultPlan` and raised on the host as
:class:`DeviceLostError` at the segment that holds the injected step,
starts a bounded retry with exponential backoff: on the sharded and
pipelined backends the world is torn down and started again on the
survivors (:func:`~repro_torch.core.world.plan_solver_world`, one respawn
per loss), the newest valid snapshot is restored and the solve resumes
from its iteration.  The formulations re-cut the logical operands at any
rank count and the warm start re-derives the rest of the carry from the
restored iterate, so the restarted solve converges to the uninterrupted
one's answer.

Segment boundaries are multiples of ``s``, so the segmented solve takes the
same outer grouping of the index stream as the uninterrupted one; the only
difference is the warm start's rounding.  Every segment runs with the guard
armed by default.  Rung two: the local backend's engine runs its own s = 1
tail (``engine._degrade_to_s1_tail``); on the distributed backends a
segment that tripped switches the remaining segments to ``s = 1`` here.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.engine import _resolve_form, get_solver, sample_blocks
from repro_torch.core.world import SolverWorld, plan_solver_world


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
                     world: SolverWorld | None = None, fault=None,
                     guard: bool = True, impl: str | None = None,
                     keep: int = 3) -> SupervisedResult:
    """Run a registered solver under supervision (see the module docstring).

    Args:
      formulation, backend: engine-registry key (``"primal"``, ``"dual"``,
        ``"proximal"``, ``"accelerated"`` x ``"local"``, ``"sharded"``,
        ``"pipelined"``).
      ckpt_dir: snapshot directory (synchronous writes: a segment is not
        done until its snapshot is committed).
      ckpt_every: snapshot cadence in OUTER steps.
      max_restarts: bound on restarts before the loss is raised again.
      backoff: base seconds of the exponential backoff (``backoff * 2**k``).
      world: the distributed backends' starting
        :class:`~repro_torch.core.world.SolverWorld`, which they require
        and the local backend refuses.  A loss respawns it on the
        survivors; it stays the caller's, with the survivors' size, after
        the solve.
      fault: optional :class:`~repro_torch.faults.FaultPlan`.  In-step kinds
        ride into every segment (``step0`` keeps the global outer numbering);
        ``device_loss`` is caught HERE and raised as
        :class:`DeviceLostError` when the solve reaches its outer step; its
        ``survivors`` default to half the ranks, at least one.
    """
    form = _resolve_form(formulation)
    solve = get_solver(formulation, backend)
    if backend == "local" and world is not None:
        raise ValueError("the local backend takes no world")
    if backend != "local" and world is None:
        raise ValueError(f"backend {backend!r} needs a SolverWorld (world=)")
    d, n = X.shape
    if idx is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or an explicit idx")
        idx = sample_blocks(generator, form.sample_dim(d, n), b, iters)
    n_shards = 1 if world is None else world.size
    mgr = CheckpointManager(ckpt_dir, keep=keep, async_save=False)

    x0 = None
    i = 0                   # inner iterations completed
    cur_s = s
    segments = restarts = total_trips = 0
    resumed_from = -1
    loss_pending = fault is not None and fault.kind == "device_loss"
    loss_iter = fault.step * s if loss_pending else -1
    w = alpha = None

    while i < iters:
        seg = min(ckpt_every * cur_s, iters - i)
        try:
            if loss_pending and i <= loss_iter < i + seg:
                loss_pending = False
                survivors = (fault.survivors if fault.survivors is not None
                             else max(1, n_shards // 2))
                raise DeviceLostError(survivors, i)
            w, alpha, trips = _run_segment(
                solve, world, form, X, y, lam, b, cur_s, seg,
                idx[i:i + seg], i // cur_s, x0, fault=fault, guard=guard,
                impl=impl, lam1=lam1)
        except DeviceLostError as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            time.sleep(backoff * 2 ** (restarts - 1))
            if world is not None:       # the lost world is gone: respawn
                n_shards = plan_solver_world(e.survivors, world).size
            restored = mgr.restore_latest(
                like={"x0": x0} if x0 is not None else None, device=X.device)
            if restored is not None:
                state, extra, _ = restored
                x0 = state["x0"]
                i = int(extra["iters_done"])
                cur_s = int(extra["cur_s"])
                resumed_from = i
            else:           # no snapshot yet: a cold restart from 0
                x0, i, resumed_from = None, 0, 0
            continue
        segments += 1
        i += seg
        total_trips += trips
        x0 = w if form.operand_layout == "rows" else alpha
        if trips and cur_s > 1 and world is not None:
            cur_s = 1       # rung two on the distributed backends
        mgr.save(i, {"x0": x0}, extra={"iters_done": i, "cur_s": cur_s},
                 block=True)
    mgr.close()
    return SupervisedResult(w, alpha, {
        "segments": segments, "restarts": restarts,
        "guard_trips": total_trips, "resumed_from_iter": resumed_from,
        "final_n_shards": n_shards, "final_s": cur_s})


def _run_segment(solve, world, form, X, y, lam, b, s, seg, seg_idx, step0,
                 x0, *, fault, guard, impl, lam1):
    """One supervised segment through the registry's solver; returns
    ``(w, alpha, trips)``, ``trips`` a host int (one read a segment)."""
    kw = {"idx": seg_idx, "guard": guard, "fault": fault, "step0": step0,
          "impl": impl}
    if lam1 is not None:
        kw["lam1"] = lam1
    if world is not None:
        out = solve(world, X, y, lam, b, s, seg, None, x0=x0, **kw)
        w, alpha = out[0], out[1]
        return w, alpha, int(out[2]["guard_trips"]) if guard else 0
    if x0 is not None:
        kw["w0" if form.operand_layout == "rows" else "alpha0"] = x0
    res = solve(X, y, lam, b, s, seg, None, **kw)
    trips = int(res.metrics["guard_trips"]) if guard else 0
    return res.w, res.alpha, trips
