"""Distributed CA-BCD / CA-BDCD over a world of ranks on ``torch.distributed``.

Starts a :class:`~repro_torch.core.world.SolverWorld` (four gloo ranks by
default; they share one card, or run on the CPU with ``--device cpu``), then

  * runs CA-BCD with X column-sharded (1D block-column, Theorem 6) and
    CA-BDCD with X row-sharded (1D block-row, Theorem 7),
  * holds both against the single-device solve on the same index stream,
  * counts the collectives the ranks made: classical = iters all-reduces,
    CA(s) = iters / s.

Run:  PYTHONPATH=src python -m repro_torch.launch.distributed_ridge
      [--device cuda|cpu] [--ranks N] [--backend gloo|nccl] [--seed N]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import SolverWorld, get_solver, sample_blocks
from repro_torch.data import SyntheticSpec, make_regression
from repro_torch.data.regression import check_device


def main(device="cuda", ranks: int = 4, backend: str = "gloo",
         seed: int = 0) -> dict:
    device = check_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    X, y, _ = make_regression(gen, SyntheticSpec("dist", d=128, n=4096,
                                                 cond=1e6),
                              torch.float64, device=device)
    lam, b, s, iters = 1e-3, 8, 8, 64
    errors = {}
    with SolverWorld(ranks, backend=backend, device=device) as world:
        print(f"world: {ranks} {backend} rank(s) on {device}")
        for form, dim, bb in (("primal", 128, b), ("dual", 4096, 16)):
            idx = sample_blocks(gen, dim, bb, iters)
            w_dist, _ = get_solver(form, "sharded")(world, X, y, lam, bb, s,
                                                    iters, idx=idx)
            w_single = get_solver(form, "local")(X, y, lam, bb, s, iters,
                                                 idx=idx).w
            errors[form] = float((w_dist - w_single).abs().max())
            name = "CA-BCD  1D-col" if form == "primal" else "CA-BDCD 1D-row"
            print(f"{name}: |w_dist - w_single| = {errors[form]:.2e}")
        idx = sample_blocks(gen, 128, b, iters)
        counts = {}
        for s_k in (1, s):
            get_solver("primal", "sharded")(world, X, y, lam, b, s_k, iters,
                                            idx=idx)
            counts[s_k] = world.last["counters"][0]["all_reduces"]
    print(f"collectives per {iters} iterations: classical={counts[1]}, "
          f"CA(s={s})={counts[s]}  -> latency / {counts[1] // counts[s]}")
    if not max(errors.values()) < 1e-10:
        raise RuntimeError(f"sharded and single solves differ: {errors}")
    return {"errors": errors, "all_reduces": counts}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises without a card")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", default="gloo",
                    help="gloo (ranks may share a card) or nccl (a card "
                         "per rank)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the data and the index streams")
    args = ap.parse_args()
    main(args.device, args.ranks, args.backend, args.seed)
