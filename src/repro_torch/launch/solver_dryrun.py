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

Usage: PYTHONPATH=src python -m repro_torch.launch.solver_dryrun
       [--out DIR] [--formulation primal|dual|proximal|accelerated]
       [--verify P [--device cuda|cpu]]
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.core import engine
from repro_torch.core.cost_model import H100_NVLINK, pipeline_schedule

D, N, B, ITERS = 4096, 1 << 22, 8, 8
CHIPS = (256, 512)
CELLS = ((1, False, "psum"), (4, False, "psum"), (4, True, "psum"),
         (8, True, "psum"), (8, True, "ring"))
ITEMSIZE = 4                    # f32 words


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
           seed: int = 0, world=None) -> list[dict]:
    """Run every cell's (s, fuse, wire) schedule on a world of P gloo ranks
    at a cut size (d = 256, n = 256 P, f32), check each rank's calls with
    the contract pass's ``check_ranks`` against :func:`schedule`'s count,
    and the words by kind against its payload; ``world`` (of at least P
    ranks) is used instead of a new one.  Raises at the first cell with a
    violation."""
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
    args = ap.parse_args()
    run(args.out, args.formulation)
    if args.verify is not None:
        verify(args.verify, args.formulation, args.device)
