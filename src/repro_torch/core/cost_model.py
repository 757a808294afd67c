"""The paper's alpha-beta-gamma running-time model (Eq. 1, Tables 1-2) plus
the modelled strong / weak scaling of Figures 8-9, with machine models of
the NVIDIA H100 the port runs on.

T = gamma * F + alpha * L + beta * W

with per-algorithm critical-path costs.  Leading constants follow the proofs
of Theorems 1/2/6/7 (Gram + residual + subproblem + vector updates); Big-O
constants the paper drops are kept as explicit small integers so the
modelled curves are reproducible, and dropping them shifts all curves
proportionally (paper footnote 3).

This is numpy only and computes what ``repro.core.cost_model`` computes, on
any :class:`MachineModel`.  The machine models differ: the paper's Cori
models are kept, and the H100 models below replace the TPU ones.  Each H100
constant says whether it is cited (with its source) or measured (with the
``chip_smoke.py`` phase, the card's name and its power limit).  The kernels'
on-chip budget is the H100's shared memory per block, read from the
kernels' own host geometries (:func:`kernel_smem_bytes`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels.gram.sampled_kernel import (  # noqa: F401
    SMEM_PER_BLOCK)  # the kernels' budget, named here beside the model


@dataclasses.dataclass(frozen=True)
class MachineModel:
    name: str
    gamma: float   # seconds per flop
    alpha: float   # seconds per message
    beta: float    # seconds per word moved


# NERSC Cori constants from the paper (section 5.2, ref [1]); Spark raises the
# effective latency to 1e-3 s per reduction (scheduling/centralization, ref [20]).
CORI_MPI = MachineModel("cori-mpi", gamma=8e-13, alpha=1e-6, beta=1.3e-10)
CORI_SPARK = MachineModel("cori-spark", gamma=8e-13, alpha=1e-3, beta=1.3e-10)

# H100 SXM.  gamma, cited: 67 TFLOP/s in f32 on the CUDA cores outside the
# tensor cores (NVIDIA H100 data sheet, dense; the port's kernels use no
# tensor cores), at the full 700 W.  Words are 4 bytes (f32).
H100_F32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12      # cited: the same data sheet, HBM3
# cited: the same data sheet, bf16 on the tensor cores, dense (the LM's
# roofline, launch/roofline.py)
H100_BF16_FLOPS = 989e12

# One card, no wire: a local solve reduces nothing (alpha = beta = 0).
H100_LOCAL = MachineModel("h100-local", gamma=1 / H100_F32_FLOPS, alpha=0.0,
                          beta=0.0)

# Ranks sharing ONE card through gloo, host-staged (core/world.py).  The
# all-reduce times of chip_smoke.py phase 9 on four ranks at its two
# payloads, 77 words (s = 1) and 16517 (s = 16), are 5.650 / 4.223 ms and
# 5.318 / 4.967 ms (primal / dual; NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md section 5's table): the spread between runs is larger than any
# effect of the payload, so beta is NOT resolved by these runs (refits of
# phase 10's own all-reduces, :func:`fit_wire`, ranged from 0 to 1.98e-8 s
# a word) and is committed as 0.  alpha, measured: the mean of the four
# times over the tree's 2 log2(P) messages.  The host time inside a call
# includes the wait for the slowest rank.  chip_smoke.py phase 10 fits
# both again and prints the refit beside these.
H100_GLOO = MachineModel("h100-gloo-1card", gamma=1 / H100_F32_FLOPS,
                         alpha=(5.650e-3 + 4.223e-3 + 5.318e-3 + 4.967e-3)
                         / 4 / 4, beta=0.0)

# One rank a card on NVLink 4 with NCCL: cited or assumed, NOT measured
# (the machine the port is measured on has one card).  beta, cited: 450
# GB/s each way a GPU (NVIDIA H100 data sheet: NVLink 900 GB/s
# bidirectional), 4-byte words.  alpha, assumed: 10 us a message, the order
# of a kernel launch plus an NVLink round trip; no source gives one number.
H100_NVLINK = MachineModel("h100-nvlink-nccl", gamma=1 / H100_F32_FLOPS,
                           alpha=1e-5, beta=4 / 450e9)

MACHINES = {m.name: m for m in (CORI_MPI, CORI_SPARK, H100_LOCAL, H100_GLOO,
                                H100_NVLINK)}


@dataclasses.dataclass(frozen=True)
class Costs:
    flops: float      # F
    latency: float    # L (number of messages)
    bandwidth: float  # W (words moved)
    memory: float     # M (words per processor)

    def time(self, m: MachineModel) -> float:
        return m.gamma * self.flops + m.alpha * self.latency + m.beta * self.bandwidth


def _logp(P: float) -> float:
    return max(math.log2(max(P, 2)), 1.0)


def bcd_costs(d: int, n: int, P: int, b: int, H: int, s: int = 1) -> Costs:
    """Theorem 1 (s=1) / Theorem 6 (s>1), 1D-block-column layout.

    Per outer iteration (every s inner iterations): one (sb x sb) Gram
    all-reduce fused with the residual, s local b x b Cholesky solves, local
    vector updates.
    """
    outer = H / s
    sb = s * b
    gram_flops = sb * sb * n / P + sb * n / P          # Y Y^T + residual panel
    solve_flops = s * (b ** 3 / 3 + 2 * b * b) + sb * sb * s  # chol + subst + corrections
    update_flops = sb + sb * n / P                     # w and alpha updates
    F = outer * (gram_flops + solve_flops + update_flops)
    L = outer * 2 * _logp(P)                           # one fused all-reduce (tree up+down)
    W = outer * (sb * sb + sb) * _logp(P)
    M = d * n / P + sb * sb + 2 * sb + d + 2 * n / P
    return Costs(F, L, W, M)


def bdcd_costs(d: int, n: int, P: int, b: int, H: int, s: int = 1) -> Costs:
    """Theorem 2 (s=1) / Theorem 7 (s>1), 1D-block-row layout; b is b'."""
    outer = H / s
    sb = s * b
    gram_flops = sb * sb * d / P + sb * d / P
    solve_flops = s * (b ** 3 / 3 + 2 * b * b) + sb * sb * s
    update_flops = sb + sb * d / P
    F = outer * (gram_flops + solve_flops + update_flops)
    L = outer * 2 * _logp(P)
    W = outer * (sb * sb + sb) * _logp(P)
    M = d * n / P + sb * sb + 2 * sb + n + 2 * d / P
    return Costs(F, L, W, M)


def snapshot_cadence(machine: MachineModel, *, d: int, n: int, P: int, b: int,
                     s: int, mtbf_outer: float, formulation: str = "primal",
                     t_snap: float | None = None, t_step: float | None = None,
                     ) -> dict:
    """Young's rule for the supervisor's snapshot interval, in OUTER steps.

    The solver carry snapshot is the logical iterate pair (w in R^d, alpha in
    R^n) -- ``d + n`` words gathered and written once, modelled as one message
    (``t_snap = alpha + beta (d + n)``).  One outer step costs the
    formulation's Theorem 6/7 critical path at H = s (``t_step``).  With
    failures arriving every ``mtbf_outer`` outer steps on average, the
    classical first-order optimum balances snapshot overhead ``t_snap / k``
    against expected replay ``k t_step / (2 mtbf)``:

        k* = sqrt(2 * mtbf_outer * t_snap / t_step)

    ``t_snap`` / ``t_step`` (seconds) replace the modelled times with
    measured ones: on one card the snapshot is a file write, which no
    alpha-beta term of a wire describes.

    Returns ``{"cadence", "t_snap", "t_step", "overhead"}`` -- cadence is
    k* clamped to >= 1, overhead the per-step fraction
    ``t_snap / (k* t_step) + k* t_step / (2 mtbf t_step)`` the supervisor
    pays for resilience.
    """
    if mtbf_outer <= 0:
        raise ValueError(f"mtbf_outer={mtbf_outer} must be > 0")
    if t_snap is None:
        t_snap = machine.alpha + machine.beta * (d + n)
    if t_step is None:
        cost_fn = bdcd_costs if formulation == "dual" else bcd_costs
        t_step = cost_fn(d, n, P, b, s, s).time(machine)
    k = max(1, round(math.sqrt(2 * mtbf_outer * t_snap / t_step)))
    overhead = t_snap / (k * t_step) + k / (2 * mtbf_outer)
    return {"cadence": k, "t_snap": t_snap, "t_step": t_step,
            "overhead": overhead}


def cg_costs(d: int, n: int, P: int, k: int) -> Costs:
    """Krylov row of Table 2: 1D layout, small-dimension vectors replicated."""
    F = k * (4 * d * n / P + 5 * min(d, n))
    L = k * 2 * _logp(P)
    W = k * min(d, n) * _logp(P)
    M = d * n / P + 4 * min(d, n)
    return Costs(F, L, W, M)


def tsqr_costs(d: int, n: int, P: int) -> Costs:
    """TSQR row of Table 2: single reduction over local R factors."""
    c, r = min(d, n), max(d, n)
    F = 2 * c * c * r / P + (2 * c ** 3 / 3) * _logp(P)
    L = _logp(P)
    W = c * c / 2 * _logp(P)
    M = d * n / P + c * c
    return Costs(F, L, W, M)


ALGORITHMS: dict[str, Callable[..., Costs]] = {
    "bcd": bcd_costs, "bdcd": bdcd_costs,
}


# --------------------------------------------------------------------------
# Batched multi-tenant solves
# --------------------------------------------------------------------------
# T tenant solves share ONE operand, ONE block-index stream, and therefore
# ONE sb x sb Gram contraction and ONE reduction per outer step; only the
# (T, sb) residual directions, the T subproblem sweeps and the T vector
# updates scale with the tenant axis.  The sync term (alpha * L) is PER
# BATCH, not per tenant.

def batched_costs(d: int, n: int, P: int, b: int, H: int, s: int = 1,
                  tenants: int = 1, formulation: str = "primal") -> Costs:
    """Critical-path costs of ONE T-tenant batched solve of H iterations.

    Shared per outer step: the sb x sb Gram contraction and the (single)
    all-reduce.  Per tenant per outer step: the residual direction, the s
    small Cholesky solves, and the iterate updates -- Theorem 6/7 terms with
    the Gram row paid once.  Wire: sb^2 + T*sb words per outer step (the
    payload law the contract pass checks).  Memory: the shared operand
    shard plus T iterate/target stripes.
    """
    if tenants < 1:
        raise ValueError(f"tenants={tenants} must be >= 1")
    outer = H / s
    sb = s * b
    c = n if formulation != "dual" else d      # local contraction length
    gram_flops = sb * sb * c / P               # shared: ONE Y Y^T per step
    per_tenant = (sb * c / P                               # residual panel
                  + s * (b ** 3 / 3 + 2 * b * b) + sb * sb * s  # subproblem
                  + sb + sb * c / P)                       # updates
    F = outer * (gram_flops + tenants * per_tenant)
    L = outer * 2 * _logp(P)                   # ONE fused all-reduce, any T
    W = outer * (sb * sb + tenants * sb) * _logp(P)
    other = d if formulation != "dual" else n  # replicated iterate length
    M = d * n / P + sb * sb + tenants * (2 * sb + other + 2 * c / P)
    return Costs(F, L, W, M)


def tenant_bytes_per_iter(d: int, n: int, P: int, b: int, s: int,
                          tenants: int, formulation: str = "primal",
                          itemsize: int = 4) -> float:
    """Wire bytes per ITERATION per TENANT of the batched solve: the shared
    Gram part splits across all T tenants, so this drops toward the
    ``b * logp`` floor of the per-tenant residual row as T grows."""
    c = batched_costs(d, n, P, b, s, s, tenants, formulation)
    return c.bandwidth * itemsize / (s * tenants)


def batched_solves_per_second(machine: MachineModel, *, d: int, n: int,
                              P: int, b: int, H: int, s: int = 1,
                              tenants: int = 1,
                              formulation: str = "primal") -> float:
    """Modelled solve throughput of the batched engine: T solves of H
    iterations finish in ONE batched critical path, so

        solves/s = T / time(batched_costs(T))

    with the sync term ``alpha * L`` amortised across the tenant axis (L is
    independent of T).  At T=1 this is exactly the single-solve rate."""
    t = batched_costs(d, n, P, b, H, s, tenants, formulation).time(machine)
    return tenants / t


# --------------------------------------------------------------------------
# Wire schedules: one all-reduce against the pipelined ring
# --------------------------------------------------------------------------
# The Theorem 6/7 rows charge the packet reduction as a tree all-reduce
# sitting serially on the critical path: 2 log2(P) messages, payload *
# log2(P) words, nothing overlapped.  The pipelined backend decomposes it
# into a ring (per axis of size P_i: a reduce-scatter of P_i - 1 hops and an
# all-gather of P_i - 1 hops; the port's world is one axis of P ranks) and
# contracts step k+1's Gram between the phases.

def ring_wire_costs(payload_words: float, axis_sizes) -> tuple[float, float]:
    """(messages, words) on the critical path of ONE dimension-wise ring
    all-reduce of ``payload_words``: per axis of size P > 1, ``2 (P - 1)``
    hops moving ``2 payload (P - 1)/P`` words; size-1 axes are free.  The
    hop count is ``engine.ring_hops``' affine ``(2, -2)`` law, which the
    contract pass checks against each rank's record of its hops."""
    L = sum(2 * (P - 1) for P in axis_sizes)
    W = sum(2 * payload_words * (P - 1) / P for P in axis_sizes if P > 1)
    return float(L), float(W)


def psum_wire_time(machine: MachineModel, payload_words: float, P: int) -> float:
    """Serial tree all-reduce: the wire term of the Theorem 6/7 rows."""
    return (machine.alpha * 2 * _logp(P)
            + machine.beta * payload_words * _logp(P))


def fit_wire(samples, P: int) -> tuple[float, float]:
    """(alpha, beta) of :func:`psum_wire_time` fitted by least squares to
    measured ``(payload_words, seconds)`` all-reduce times on P ranks, each
    clamped at zero (a wire time that does not grow with the payload fits
    beta = 0)."""
    A = np.array([[2 * _logp(P), w * _logp(P)] for w, _ in samples],
                 dtype=np.float64)
    t = np.array([sec for _, sec in samples], dtype=np.float64)
    (alpha, beta), *_ = np.linalg.lstsq(A, t, rcond=None)
    if beta < 0:
        alpha, beta = float(t.mean() / (2 * _logp(P))), 0.0
    return max(float(alpha), 0.0), float(beta)


def ring_wire_time(machine: MachineModel, payload_words: float,
                   axis_sizes) -> float:
    """End-to-end time of the decomposed ring reduction (no overlap credit;
    that is ``pipeline_schedule``'s job)."""
    L, W = ring_wire_costs(payload_words, axis_sizes)
    return machine.alpha * L + machine.beta * W


def pipeline_schedule(machine: MachineModel, *, d: int, n: int, axis_sizes,
                      b: int, s: int, tenants: int = 1,
                      formulation: str = "primal", guard: bool = False,
                      fma: float = 2.0) -> dict:
    """Alpha-beta-gamma model of ONE outer step under both wire schedules.

    The overlappable work per outer step is the step's own compute -- the
    shared Gram contraction (issued one step ahead by the pipelined drive)
    plus the T tenants' sweeps and deferred updates -- so the ring hides
    ``t_hidden = min(t_compute, t_wire_ring)`` of its wire and exposes the
    rest; the single all-reduce exposes ALL of its wire by construction.

    ``fma=2.0`` converts the Theorem-style cell counts (one per multiply-add)
    to hardware flops, since machine peaks count the FMA as two.

    The payload is the reference's: ``sb^2 + T sb`` words, plus the health
    word's five with ``guard``.  (The port's sharded packet always carries
    the five slots, zero unguarded; five words move no modelled time.)

    Returns a dict with ``payload_words``, ``hops``, ``t_compute``,
    ``t_wire_psum``, ``t_wire_ring``, ``t_hidden``, ``t_exposed_ring``,
    ``t_exposed_psum``, ``overlap_ratio`` (hidden/total ring wire, in
    [0, 1]), and ``step_speedup`` (serial-psum step over pipelined step).
    """
    axis_sizes = tuple(int(P) for P in axis_sizes)
    P = math.prod(axis_sizes)
    sb = s * b
    payload = sb * sb + tenants * sb
    if guard:
        from .engine import HEALTH_WORDS
        payload += HEALTH_WORDS
    # one outer step == the H=s slice of the batched critical path
    F_step = batched_costs(d, n, P, b, s, s, tenants, formulation).flops
    t_compute = machine.gamma * fma * F_step
    t_psum = psum_wire_time(machine, payload, P)
    t_ring = ring_wire_time(machine, payload, axis_sizes)
    t_hidden = min(t_compute, t_ring)
    ratio = t_hidden / t_ring if t_ring > 0 else 1.0
    t_step_serial = t_compute + t_psum
    t_step_pipe = max(t_compute, t_ring)
    return {
        "payload_words": float(payload),
        "hops": float(ring_wire_costs(payload, axis_sizes)[0]),
        "t_compute": t_compute,
        "t_wire_psum": t_psum,
        "t_wire_ring": t_ring,
        "t_hidden": t_hidden,
        "t_exposed_ring": t_ring - t_hidden,
        "t_exposed_psum": t_psum,
        "overlap_ratio": ratio,
        "step_speedup": t_step_serial / t_step_pipe if t_step_pipe else 1.0,
    }


def overlap_ratio(machine: MachineModel, *, d: int, n: int, axis_sizes,
                  b: int, s: int, tenants: int = 1,
                  formulation: str = "primal", guard: bool = False) -> float:
    """Fraction of the ring reduction's wire time hidden behind compute."""
    return pipeline_schedule(machine, d=d, n=n, axis_sizes=axis_sizes, b=b,
                             s=s, tenants=tenants, formulation=formulation,
                             guard=guard)["overlap_ratio"]


# --------------------------------------------------------------------------
# Per-device HBM traffic of the Gram-packet hot path (the gather term)
# --------------------------------------------------------------------------
# The alpha-beta-gamma model above counts inter-device words (W); on the
# card the roofline is governed by HBM bytes, and the dominant term of one
# outer iteration is how often the sampled sb x n panel crosses HBM.  A
# materialised panel Y = X[flat] costs a gather read, a write and a read
# back per use (B + 3 crossings with B = ceil(sb/bm) row blocks of the Gram);
# the panel-free kernels read X's rows straight into shared memory (B + 1).
#
# Column gather (layout="cols", the dual's operand in X's original layout):
# each sampled element of a column is a scattered read, so every panel
# crossing over-reads by the memory's granule: ``lane`` x the useful bytes.

SECTOR_BYTES = 32   # the H100's memory granule for a scattered read


def packet_hbm_bytes(sb: int, n: int, itemsize: int = 4,
                     panel_free: bool = True, bm: int = 128,
                     layout: str = "rows", lane: int | None = None) -> float:
    """Modelled HBM bytes of ONE outer iteration's packet + deferred apply.
    ``n`` is the contraction length (operand columns for ``layout="rows"``;
    X's rows d for ``layout="cols"``); ``bm`` is the kernel's G tile edge.
    ``layout="cols"`` amplifies the panel-crossing term by ``lane``: by
    default the H100's granule, one 32-byte sector a scattered element
    (``SECTOR_BYTES // itemsize`` elements), the bound convention of
    PERF.md's kernel table; ``lane=128`` is the TPU's 128-lane slab, the
    reference's default."""
    if layout not in ("rows", "cols"):
        raise ValueError(f"unknown layout {layout!r}")
    if lane is None:
        lane = max(1, SECTOR_BYTES // itemsize)
    amp = lane if layout == "cols" else 1
    panel = sb * n * amp
    blocks = -(-sb // max(bm, 1))
    shared = 3 * n + sb * sb + 2 * sb
    crossings = (blocks + 1) if panel_free else (blocks + 3)
    return float((crossings * panel + shared) * itemsize)


def packet_traffic_breakdown(sb: int, n: int, itemsize: int = 4,
                             bm: int = 128) -> dict:
    """Both schedules' modelled bytes plus the ratio ((B+1)/(B+3) ~= 1/2
    while sb <= bm)."""
    base = packet_hbm_bytes(sb, n, itemsize, panel_free=False, bm=bm)
    fused = packet_hbm_bytes(sb, n, itemsize, panel_free=True, bm=bm)
    return {"baseline_bytes": base, "panel_free_bytes": fused,
            "ratio": fused / base}


def _tile_edge(sb: int, K: int, layout: str) -> int:
    from repro_torch.kernels.gram.gram_kernel import dense_geometry
    return dense_geometry(sb, K, torch.float32, source=layout).bm


def dual_operand_tradeoff(d: int, n: int, sb: int, itemsize: int = 4,
                          bm_rows: int | None = None,
                          bm_cols: int | None = None,
                          lane: int | None = None) -> dict:
    """Both sides of the dual-layout trade, per operand strategy:

    * ``pretranspose``: row-gather traffic on ``X.T``, but the transposed
      copy doubles the resident dataset for the whole solve.
    * ``colgather``: the original layout stays the only copy; each panel
      crossing pays the ``lane`` amplification instead.

    Each schedule is modelled at ITS OWN kernel's G tile edge (the packet
    kernels' host geometry, ``dense_geometry``, unless ``bm_rows`` /
    ``bm_cols`` pin them).  ``resident_bytes`` counts the dataset copies
    plus the solve's vectors (w in R^d, alpha and y in R^n).
    """
    if bm_rows is None:
        bm_rows = _tile_edge(sb, d, "rows")
    if bm_cols is None:
        bm_cols = _tile_edge(sb, d, "cols")
    vectors = (d + 2 * n) * itemsize
    data = d * n * itemsize
    return {
        "pretranspose": {
            "resident_bytes": float(2 * data + vectors),
            "hbm_bytes_per_iter": packet_hbm_bytes(
                sb, d, itemsize, panel_free=True, bm=bm_rows, layout="rows"),
        },
        "colgather": {
            "resident_bytes": float(data + vectors),
            "hbm_bytes_per_iter": packet_hbm_bytes(
                sb, d, itemsize, panel_free=True, bm=bm_cols, layout="cols",
                lane=lane),
        },
    }


# The kernels' on-chip budget: dynamic shared memory a block may use on the
# H100 (227 KiB, opted in per kernel; sampled_kernel.SMEM_PER_BLOCK).  The
# plan pass (repro_torch.analysis.plan_pass) checks every dispatchable chunk
# against it, and chip_smoke.py phase 10 against the card's own limit.

def kernel_smem_bytes(m: int, K: int, dtype=torch.float32,
                      layout: str = "rows") -> int:
    """Dynamic shared memory of the layout's sampled kernels for an (m
    samples, K contraction) packet: the larger of the packet's tile ring
    (``gram_kernel.dense_geometry``, K1 / K3) and the matvec's ring at one
    tenant (``sampled_kernel.matvec_geometry``, K6 / K5).  Both are the
    kernels' own host geometries, so the modelled and the launched
    footprints are one number.  The apply kernels (K2 / K4) take no dynamic
    shared memory.  A geometry over the budget raises there."""
    from repro_torch.kernels.gram.gram_kernel import dense_geometry
    from repro_torch.kernels.gram.sampled_kernel import matvec_geometry
    if layout not in ("rows", "cols"):
        raise ValueError(f"unknown layout {layout!r}")
    packet = dense_geometry(m, K, dtype, source=layout)
    matvec = matvec_geometry(m, K, 1, dtype, layout)
    return max(packet.smem, matvec.smem)


def packet_memory_time(sb: int, n: int, hbm_bytes_per_s: float,
                       itemsize: int = 4, panel_free: bool = True,
                       bm: int = 128) -> float:
    """Memory-bound roofline time of one outer iteration."""
    return packet_hbm_bytes(sb, n, itemsize, panel_free, bm) / hbm_bytes_per_s


def best_s(cost_fn, machine: MachineModel, d: int, n: int, P: int, b: int,
           H: int, s_grid=None) -> tuple[int, float]:
    """min_s T(s): returns (s*, T(s*)).  s=1 recovers the classical algorithm,
    so T(s*) <= T(classical) by construction -- the paper's tuning story."""
    if s_grid is None:
        s_grid = [1, 2, 5, 10, 25, 40, 50, 100, 200, 300, 600, 750, 1000]
    best = (1, float("inf"))
    for s in s_grid:
        if H % s:
            continue
        t = cost_fn(d, n, P, b, H, s).time(machine)
        if t < best[1]:
            best = (s, t)
    return best


def _scaling(machine, *, d, b, H, Ps, s_grid, n_of) -> dict:
    out = {"P": [], "t_classical": [], "t_ca": [], "s": [], "speedup": []}
    for P in Ps:
        n = n_of(P)
        t1 = bcd_costs(d, n, P, b, H, 1).time(machine)
        s, ts = best_s(bcd_costs, machine, d, n, P, b, H, s_grid)
        out["P"].append(P)
        out["t_classical"].append(t1)
        out["t_ca"].append(ts)
        out["s"].append(s)
        out["speedup"].append(t1 / ts)
    return {k: np.asarray(v) for k, v in out.items()}


def strong_scaling(machine: MachineModel, *, d: int, n: int, b: int, H: int,
                   Ps, s_grid=None) -> dict:
    """Figure 8: fixed problem, growing P.  Returns per-P classical time,
    best-s CA time, the chosen s, and the speedup."""
    return _scaling(machine, d=d, b=b, H=H, Ps=Ps, s_grid=s_grid,
                    n_of=lambda P: n)


def weak_scaling(machine: MachineModel, *, d: int, n_per_P: int, b: int, H: int,
                 Ps, s_grid=None) -> dict:
    """Figure 9: n = n_per_P * P."""
    return _scaling(machine, d=d, b=b, H=H, Ps=Ps, s_grid=s_grid,
                    n_of=lambda P: n_per_P * P)
