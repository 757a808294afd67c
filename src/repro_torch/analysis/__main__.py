"""Command line: ``python -m repro_torch.analysis {sweep,lint}``.

``sweep`` runs all three passes -- the contract pass on a world of four
gloo ranks on ``--device`` (the card unless ``--device cpu``),
the plan pass and the lint pass -- writes the JSON report to ``--out``
(default ``artifacts/analysis_torch.json``; the root ``ANALYSIS.json`` is
the reference's), prints a summary and exits nonzero on any violation.
``lint`` runs the AST pass alone (standard library only).
"""
from __future__ import annotations

import argparse
import os
import sys

from .report import Report

DEFAULT_OUT = os.path.join("artifacts", "analysis_torch.json")
RANKS = 4       # the contract pass's world, as the reference's 8-device mesh


def run_sweep(world=None, *, device="cuda", formulations=None) -> Report:
    """All three passes -> one Report.  The contract pass runs on ``world``
    (a :class:`~repro_torch.core.world.SolverWorld`), or on a gloo world of
    :data:`RANKS` ranks on ``device`` made for the call and closed after."""
    import torch

    from repro_torch.core.world import SolverWorld

    from .contract_pass import run_contract_pass
    from .lint import run_lint
    from .plan_pass import run_plan_pass

    own = world is None
    if own:
        world = SolverWorld(RANKS, backend="gloo", device=device)
    try:
        report = Report(meta={
            "torch_version": torch.__version__, "device": str(world.device),
            "device_name": (torch.cuda.get_device_name(world.device)
                            if world.device.type == "cuda" else "cpu"),
            "ranks": world.size, "backend": world.backend})
        report.passes.append(run_contract_pass(world, formulations))
    finally:
        if own:
            world.close()
    report.passes.append(run_plan_pass())
    report.passes.append(run_lint(repo_root=os.getcwd()))
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's contract engine")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_sweep = sub.add_parser(
        "sweep", help="all three passes over the solver registry")
    p_sweep.add_argument("--out", default=DEFAULT_OUT,
                         help=f"report path (default: {DEFAULT_OUT})")
    p_sweep.add_argument("--device", default="cuda",
                         help="device of the ranks and the local solves "
                              "(default: cuda; 'cpu' runs the plain "
                              "versions)")
    p_sweep.add_argument("--formulation", action="append", default=None,
                         help="restrict to one formulation (repeatable)")

    p_lint = sub.add_parser("lint", help="convention lint pass only")
    p_lint.add_argument("paths", nargs="*", default=None,
                        help="files/trees to lint (default: src/repro_torch "
                             "chip_smoke.py)")

    args = parser.parse_args(argv)

    if args.cmd == "lint":
        from .lint import run_lint
        rep = run_lint(paths=args.paths or None, repo_root=os.getcwd())
        report = Report(passes=[rep])
        print(report.summary())
        return 0 if report.ok else 1

    report = run_sweep(device=args.device, formulations=args.formulation)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        f.write(report.to_json() + "\n")
    print(report.summary())
    print(f"report written to {args.out}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
