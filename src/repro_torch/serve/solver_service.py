"""Continuous-batching front end for the tenant-batched s-step engine.

Solve requests (a target ``y``, an l2 weight ``lam``, optional formulation
coefficients, a per-request residual tolerance) queue into the free slots of
a :class:`~repro_torch.serve.slots.SlotTable`, and every :meth:`step`
advances all live solves by one chunk of iterations through ONE
:func:`~repro_torch.core.s_step_solve_batched` call: one Gram packet and one
residual-direction launch per outer step, shared by every tenant.

The live tenants are padded to a power-of-two bucket; the padding rows ride
inactive and take no update.  Between chunks, the host reads each tenant's
``residual`` metric against that request's own tolerance and frees the slot
of a converged or capped request.

Index chunks come from a ``torch.Generator`` on X's device seeded from
``cfg.seed``, drawn through the module-level name :func:`sample_blocks`, so
that a caller can hand the service an index stream of its own.  The per-slot
carries stay on X's device; tickets hold numpy arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import (SolverPlan, TenantBatch, batched_residuals,
                              s_step_solve_batched, sample_blocks)
from repro_torch.core.engine import _resolve_form
from repro_torch.serve.slots import SlotTable, bucket_pow2


@dataclasses.dataclass
class SolverServiceConfig:
    slots: int = 64             # table width == most concurrent tenants
    min_bucket: int = 8         # smallest tenant bucket
    chunk_iters: int = 32       # iterations advanced per step()
    max_iters: int = 1024       # per-request cap (no-tol requests stop here)
    tol: float | None = None    # default per-request tolerance (None: to cap)
    seed: int = 0               # block-index stream seed


@dataclasses.dataclass
class SolveTicket:
    """What a finished request leaves behind."""
    w: np.ndarray
    alpha: np.ndarray
    iters: int
    residual: float
    converged: bool             # True: hit its tolerance; False: the cap


class SolverService:
    """Slot-based many-tenant solve server over one shared operand ``X``."""

    def __init__(self, X: torch.Tensor, plan: SolverPlan,
                 formulation: str = "primal",
                 cfg: SolverServiceConfig | None = None):
        cfg = cfg or SolverServiceConfig()
        if cfg.min_bucket > cfg.slots:
            raise ValueError(
                f"min_bucket {cfg.min_bucket} exceeds slots {cfg.slots}")
        if plan.tenants is not None:
            raise ValueError(
                "SolverPlan.tenants is set by the service per bucket; pass a "
                "plan with tenants=None")
        self.X = X
        self.plan = plan
        self.formulation = formulation
        self.form = _resolve_form(formulation)
        self.cfg = cfg
        self.table = SlotTable(cfg.slots)
        d, n = X.shape
        self.d, self.n = d, n
        opts = {"dtype": X.dtype, "device": X.device}
        # Per-slot tenant state: vectors on X's device, scalars on the host.
        self.ys = torch.zeros((cfg.slots, n), **opts)
        self.ws = torch.zeros((cfg.slots, d), **opts)
        self.alphas = torch.zeros((cfg.slots, n), **opts)
        self.lams = [1.0] * cfg.slots
        self.coeffs: dict[str, list[float]] = {}
        self.iters_run = np.zeros((cfg.slots,), np.int64)
        self.tols = np.full((cfg.slots,), np.inf)
        self.generator = torch.Generator(device=X.device).manual_seed(cfg.seed)

    # ------------------------------------------------------------- intake --
    def submit(self, y, lam: float, *, tol: float | None = None,
               **coeffs) -> int:
        """Queue one solve.  ``coeffs`` are per-tenant formulation fields
        (``lam1=`` for the proximal); every request of one service passes
        the same names."""
        y = torch.as_tensor(y, dtype=self.X.dtype)
        if tuple(y.shape) != (self.n,):
            raise ValueError(f"y shape {tuple(y.shape)} != ({self.n},)")
        if self.table.requests and set(coeffs) != set(self.coeffs):
            raise ValueError(
                f"coefficient names {sorted(coeffs)} differ from the "
                f"service's {sorted(self.coeffs)}")
        for k in coeffs:
            self.coeffs.setdefault(k, [0.0] * self.cfg.slots)
        return self.table.submit(
            {"y": y, "lam": float(lam),
             "tol": self.cfg.tol if tol is None else float(tol),
             "coeffs": {k: float(v) for k, v in coeffs.items()}})

    # -------------------------------------------------------------- serve --
    def step(self) -> dict[int, SolveTicket]:
        """Admit queued requests, advance every live solve by one chunk,
        retire those that hit their tolerance or the iteration cap.
        Returns {rid: ticket} for the requests finished in this step."""
        for req in self.table.admit():
            s, p = req.slot, req.payload
            self.ys[s] = p["y"].to(self.X.device)
            self.lams[s] = p["lam"]
            self.tols[s] = np.inf if p["tol"] is None else p["tol"]
            for k in self.coeffs:
                self.coeffs[k][s] = p["coeffs"].get(k, 0.0)
            self.ws[s] = 0.0
            self.alphas[s] = 0.0
            self.iters_run[s] = 0
        live = self.table.active_slots()
        if not live:
            return {}

        bucket = bucket_pow2(len(live), self.cfg.min_bucket, self.cfg.slots)
        rows = (live + [live[0]] * (bucket - len(live)))[:bucket]
        active0 = [i < len(live) for i in range(bucket)]
        idx = sample_blocks(self.generator,
                            self.form.sample_dim(self.d, self.n),
                            self.plan.b, self.cfg.chunk_iters)
        res = s_step_solve_batched(
            self.formulation, dataclasses.replace(self.plan, tenants=bucket),
            self.X, self._batch(rows), self.cfg.chunk_iters, idx=idx,
            carry0=(self.ws[rows], self.alphas[rows]), active0=active0)
        self.ws[live] = res.ws[:len(live)]
        self.alphas[live] = res.alphas[:len(live)]
        self.iters_run[live] += self.cfg.chunk_iters

        resid = batched_residuals(self.formulation, self.X, self._batch(live),
                                  (self.ws[live], self.alphas[live])).tolist()
        finished: dict[int, SolveTicket] = {}
        for i, s in enumerate(live):
            hit_tol = bool(np.isfinite(self.tols[s])
                           and resid[i] <= self.tols[s])
            capped = self.iters_run[s] >= self.cfg.max_iters
            if not (hit_tol or capped):
                continue
            req = self.table.retire(s)
            ticket = SolveTicket(
                w=self.ws[s].cpu().numpy().copy(),
                alpha=self.alphas[s].cpu().numpy().copy(),
                iters=int(self.iters_run[s]), residual=float(resid[i]),
                converged=hit_tol)
            req.out.append(ticket)
            finished[req.rid] = ticket
        return finished

    def serve(self, max_steps: int | None = None) -> dict[int, SolveTicket]:
        """Run :meth:`step` until the queue and the table drain (or
        ``max_steps``).  Returns every ticket finished along the way."""
        done: dict[int, SolveTicket] = {}
        steps = 0
        while self.table.pending or self.table.any_active:
            if max_steps is not None and steps >= max_steps:
                break
            done.update(self.step())
            steps += 1
        return done

    def result(self, rid: int) -> SolveTicket | None:
        req = self.table.requests[rid]
        return req.out[-1] if req.done and req.out else None

    def _batch(self, rows: list[int]) -> TenantBatch:
        return TenantBatch(
            ys=self.ys[rows], lams=[self.lams[r] for r in rows],
            coeffs={k: [v[r] for r in rows] for k, v in self.coeffs.items()})
