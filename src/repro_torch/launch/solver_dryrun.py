"""The paper's own technique at the production scale, without the hardware:
the wire schedule that the solvers' contracts give for (CA-)BCD / (CA-)BDCD
at the reference's production geometry (d = 4096, n = 2**22, b = 8, 8
iterations) on P = 256 and 512 ranks, with the cost model's one-step
schedule (``cost_model.pipeline_schedule``) on NVLink beside it:

    schedule              syncs / H iters     words / H iters
    unfused s=1                 H             H (b (b + 1) + 5)
    unfused s                   H/s           (H/s) (sb (sb + 1) + 5)
    fused s                     H/s           (H/s) (sb (sb + 1) + 5)
    ring s                      0 all-reduces, 2 (P - 1) H/s hops

(the port's packet carries the health word's five slots in every layout;
fused and unfused differ only in how the words are laid out).  The
reference lowers and compiles the solvers on 512 abstract devices and
counts the collectives in the HLO; torch has no abstract lowering, so the
counts here are the contracts' (``SolverContracts``: ``sync_per_outer``,
``pipelined_hops``), and ``--verify P`` runs the same (s, fuse, wire)
schedules on a :class:`~repro_torch.core.world.SolverWorld` of P ranks at
a cut size and checks every rank's record of its calls against them.  The
NVLink model's constants are cited, not measured
(``cost_model.H100_NVLINK``).

``--tenants T`` gives the batched cells instead (:func:`run_batched`): T
tenant solves on one reduction per outer step at s in {1, 4, 8}, H
all-reduces whatever T, each of sb^2 + T sb words (the shared Gram not
scaled by T; no health word), with the model's batched solves/s and
wire bytes a tenant iteration beside them; with ``--verify P`` the
batched schedules also run on the world (``s_step_solve_batched_sharded``)
and every rank's record is checked against them.

Usage: PYTHONPATH=src python -m repro_torch.launch.solver_dryrun
       [--out DIR] [--formulation primal|dual|proximal|accelerated]
       [--tenants T] [--verify P [--device cuda|cpu]]
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.core import engine
from repro_torch.core.cost_model import (H100_NVLINK,
                                         batched_solves_per_second,
                                         pipeline_schedule,
                                         tenant_bytes_per_iter)

D, N, B, ITERS = 4096, 1 << 22, 8, 8
CHIPS = (256, 512)
CELLS = ((1, False, "psum"), (4, False, "psum"), (4, True, "psum"),
         (8, True, "psum"), (8, True, "ring"))
ITEMSIZE = 4                    # f32 words
BATCHED_S = (1, 4, 8)


def schedule(form, P: int, s: int, wire: str, b: int = B,
             iters: int = ITERS) -> dict:
    """The calls per solve that ``form``'s contracts give on P ranks:
    all-reduces, words all-reduced, hops and words sent by the hops (each
    hop one of P chunks of the padded packet)."""
    c = form.contracts()
    H = -(-iters // s)
    payload = s * b * (s * b + 1) + engine.HEALTH_WORDS
    if wire == "psum":
        return {"all_reduces": c.sync_per_outer * H,
                "words": c.sync_per_outer * H * payload, "hops": 0,
                "hop_words": 0}
    hops = engine.ring_hops([P], c.pipelined_hops) * H
    return {"all_reduces": 0, "words": 0, "hops": hops,
            "hop_words": hops * -(-payload // P)}


def batched_schedule(P: int, s: int, tenants: int, b: int = B,
                     iters: int = ITERS) -> dict:
    """The calls of one T-tenant batched solve on P ranks: one all-reduce
    an outer step (H, whatever T), each of sb_k^2 + T sb_k words (the
    ragged tail's sb_k smaller; the Gram part independent of T)."""
    steps = [s] * (iters // s) + ([iters % s] if iters % s else [])
    words = sum((k * b) ** 2 + tenants * k * b for k in steps)
    return {"all_reduces": len(steps), "words": words, "hops": 0,
            "hop_words": 0}


def _model_form(form) -> str:
    return "dual" if form.operand_layout == "cols" else "primal"


def run_batched(tenants: int, out_dir: str = "artifacts/solver_torch",
                formulation: str = "primal") -> list[dict]:
    """The batched cells at the production geometry on P in CHIPS and s in
    BATCHED_S: the schedule, and the NVLink model's solves/s, wire bytes a
    tenant iteration and one-step overlap fields at T tenants.  Writes
    ``solver_cells_batched_T{T}.json``."""
    form = engine._resolve_form(formulation)
    model_form = _model_form(form)
    results = []
    for P in CHIPS:
        for s in BATCHED_S:
            sched = batched_schedule(P, s, tenants)
            model = pipeline_schedule(H100_NVLINK, d=D, n=N, axis_sizes=(P,),
                                      b=B, s=s, tenants=tenants,
                                      formulation=model_form)
            rec = {"chips": P, "s": s, "formulation": formulation,
                   "operand_layout": form.operand_layout,
                   "tenants": tenants, "iters": ITERS, **sched,
                   "wire_bytes": sched["words"] * ITEMSIZE,
                   "machine": H100_NVLINK.name,
                   "modeled_solves_per_s": batched_solves_per_second(
                       H100_NVLINK, d=D, n=N, P=P, b=B, H=ITERS, s=s,
                       tenants=tenants, formulation=model_form),
                   "modeled_bytes_per_iter_per_tenant":
                       tenant_bytes_per_iter(D, N, P, B, s, tenants,
                                             model_form),
                   "modeled_overlap_ratio": model["overlap_ratio"],
                   "modeled_exposed_psum_s": model["t_exposed_psum"],
                   "modeled_exposed_ring_s": model["t_exposed_ring"],
                   "modeled_ring_hops": model["hops"]}
            results.append(rec)
            print(f"[solver-dryrun] batched P={P} T={tenants} s={s}: "
                  f"{sched['all_reduces']} all-reduces / {ITERS} iters, "
                  f"{rec['wire_bytes']:.3e} B a rank, "
                  f"{rec['modeled_solves_per_s']:.1f} modelled solves/s",
                  flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir,
                           f"solver_cells_batched_T{tenants}.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


def run(out_dir: str = "artifacts/solver_torch",
        formulation: str = "primal") -> list[dict]:
    form = engine._resolve_form(formulation)
    model_form = "dual" if form.operand_layout == "cols" else "primal"
    results = []
    for P in CHIPS:
        for s, fused, wire in CELLS:
            sched = schedule(form, P, s, wire)
            model = pipeline_schedule(H100_NVLINK, d=D, n=N, axis_sizes=(P,),
                                      b=B, s=s, formulation=model_form)
            rec = {"chips": P, "s": s, "fused": fused, "wire": wire,
                   "formulation": formulation,
                   "operand_layout": form.operand_layout, "iters": ITERS,
                   **sched,
                   "wire_bytes": (sched["words"] + sched["hop_words"])
                   * ITEMSIZE,
                   "machine": H100_NVLINK.name,
                   "modeled_overlap_ratio": model["overlap_ratio"],
                   "modeled_exposed_psum_s": model["t_exposed_psum"],
                   "modeled_exposed_ring_s": model["t_exposed_ring"],
                   "modeled_ring_hops": model["hops"],
                   "modeled_step_speedup": model["step_speedup"]}
            results.append(rec)
            print(f"[solver-dryrun] P={P} s={s} fused={fused} wire={wire}: "
                  f"{sched['all_reduces']} all-reduces, {sched['hops']} hops "
                  f"/ {ITERS} iters, {rec['wire_bytes']:.3e} B a rank; "
                  f"modelled overlap {model['overlap_ratio']:.2f}",
                  flush=True)
    os.makedirs(out_dir, exist_ok=True)
    fname = ("solver_cells.json" if formulation == "primal"
             else f"solver_cells_{formulation}.json")
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(results, f, indent=1)
    return results


def verify(P: int, formulation: str = "primal", device="cuda",
           seed: int = 0, world=None, tenants: int | None = None
           ) -> list[dict]:
    """Run every cell's (s, fuse, wire) schedule on a world of P gloo ranks
    at a cut size (d = 256, n = 256 P, f32), check each rank's calls with
    the contract pass's ``check_ranks`` against :func:`schedule`'s count,
    and the words by kind against its payload; with ``tenants`` the
    batched schedules instead (:func:`batched_schedule`, one batched
    sharded solve of T tenants at each s of BATCHED_S).  ``world`` (of at
    least P ranks) is used instead of a new one.  Raises at the first cell
    with a violation."""
    from repro_torch.analysis.contract_pass import check_ranks
    from repro_torch.analysis.report import PassReport, Violation
    from repro_torch.core import SolverWorld, sample_blocks
    form = engine._resolve_form(formulation)
    contract = form.contracts()
    kw = dict(contract.sweep_kwargs)
    own = world is None
    if own:
        world = SolverWorld(P, backend="gloo", device=device)
    device = world.device
    gen = torch.Generator().manual_seed(seed)
    d, n = 256, 256 * P
    X = torch.randn((d, n), generator=gen).to(device)
    y = torch.randn((n,), generator=gen).to(device)
    idx = sample_blocks(gen, form.sample_dim(d, n), B, ITERS)
    rep = PassReport("solver-dryrun-verify")
    rows = []
    tap, world.tap_wire = world.tap_wire, True
    try:
        if tenants is not None:
            return _verify_batched(world, form, contract, P, tenants, X, y,
                                   idx, device, rep)
        for s, fused, wire in CELLS:
            solve = engine.get_solver(
                formulation, "pipelined" if wire == "ring" else "sharded")
            solve(world.ranks(P), X, y, 1e-3, B, s, ITERS, idx=idx,
                  fuse_packet=fused, **kw)
            want = schedule(form, P, s, wire)
            case = rep.case(f"{formulation}/P={P},s={s},fused={fused},"
                            f"wire={wire}")
            kinds, key = ((contract.collective_kinds, "all_reduces")
                          if wire == "psum" else
                          (contract.pipelined_collective_kinds, "hops"))
            summ = check_ranks(world, kinds, want[key], case,
                               rep.violations)
            got = {"words": summ.by_kind.get("all_reduce", (0, 0))[1],
                   "hop_words": summ.by_kind.get("hop", (0, 0))[1]}
            if got != {k: want[k] for k in got}:
                rep.violations.append(Violation(
                    "collective-payload", case,
                    f"moved {got}, the contracts give {want}"))
            if not rep.ok:
                raise AssertionError("\n".join(map(str, rep.violations)))
            rows.append({"ranks": P, "s": s, "fused": fused, "wire": wire,
                         **want})
            print(f"[solver-dryrun] verified on {P} ranks ({device}): s={s} "
                  f"fused={fused} wire={wire}: {want}", flush=True)
    finally:
        world.tap_wire = tap
        if own:
            world.close()
    return rows


def _verify_batched(world, form, contract, P, tenants, X, y, idx, device,
                    rep) -> list[dict]:
    from repro_torch.analysis.contract_pass import check_ranks
    from repro_torch.analysis.report import Violation
    gen = torch.Generator().manual_seed(1)
    ys = torch.randn((tenants, y.shape[0]), generator=gen).to(device)
    coeffs = {k: [v] * tenants for k, v in contract.sweep_kwargs}
    batch = engine.TenantBatch(ys=ys, lams=[1e-3] * tenants, coeffs=coeffs)
    rows = []
    for s in BATCHED_S:
        want = batched_schedule(P, s, tenants)
        world.solve_batched(form, engine.SolverPlan(b=B, s=s), X, batch,
                            ITERS, idx=idx, n_ranks=P)
        case = rep.case(f"{form.name}/batched[P={P},T={tenants},s={s}]")
        summ = check_ranks(world, contract.collective_kinds,
                           want["all_reduces"], case, rep.violations)
        words = summ.by_kind.get("all_reduce", (0, 0))[1]
        if words != want["words"]:
            rep.violations.append(Violation(
                "collective-payload", case,
                f"moved {words} words, the batched schedule gives "
                f"{want['words']}"))
        if not rep.ok:
            raise AssertionError("\n".join(map(str, rep.violations)))
        per_rank = [c["all_reduces"] for c in world.last["counters"]]
        rows.append({"ranks": P, "tenants": tenants, "s": s, **want,
                     "all_reduces_by_rank": per_rank})
        print(f"[solver-dryrun] verified on {P} ranks ({device}): batched "
              f"T={tenants} s={s}: {per_rank} all-reduces by rank, "
              f"{words} words", flush=True)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts/solver_torch")
    ap.add_argument("--formulation", default="primal",
                    help="registry formulation: primal | dual | proximal | "
                         "accelerated")
    ap.add_argument("--verify", type=int, default=None, metavar="P",
                    help="also run the schedules on a world of P ranks")
    ap.add_argument("--device", default="cuda",
                    help="device of the --verify world (default: cuda)")
    ap.add_argument("--tenants", type=int, default=None,
                    help="the batched cells at this tenant-axis width "
                         "instead of the single-solve cells")
    args = ap.parse_args()
    if args.tenants is not None:
        run_batched(args.tenants, args.out, args.formulation)
    else:
        run(args.out, args.formulation)
    if args.verify is not None:
        rows = verify(args.verify, args.formulation, args.device,
                      tenants=args.tenants)
        if args.tenants is not None:
            with open(os.path.join(
                    args.out, f"solver_cells_batched_T{args.tenants}"
                    f"_verified_p{args.verify}.json"), "w") as f:
                json.dump(rows, f, indent=1)
