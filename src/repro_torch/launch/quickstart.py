"""Quickstart: the paper in a minute, on the card.

Solves a ridge problem with classical BCD and CA-BCD(s) through the CUDA
kernels, showing
  1. identical convergence trajectories (the exact-arithmetic claim, in f64),
  2. s-fold fewer synchronization points (the latency claim).

Run:  PYTHONPATH=src python -m repro_torch.launch.quickstart
      [--device cuda|cpu] [--impl ref|cuda] [--seed N]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import get_solver, ridge_exact, sample_blocks
from repro_torch.data import SyntheticSpec, make_regression
from repro_torch.data.regression import check_device


def main(impl: str | None = None, seed: int = 0, device="cuda") -> float:
    device = check_device(device)
    solve = get_solver("primal", "local")
    gen = torch.Generator(device=device).manual_seed(seed)
    # A news20-shaped problem: more features than data points, ill-conditioned.
    X, y, _ = make_regression(gen, SyntheticSpec("demo", d=512, n=2048,
                                                 cond=1e6),
                              torch.float64, device=device)
    lam = 1e-6 * float(torch.linalg.norm(X) ** 2)
    w_opt = ridge_exact(X, y, lam)
    print(f"problem: X {tuple(X.shape)} on {device}, lambda={lam:.3e}")

    iters, b, s = 1000, 8, 25
    idx = sample_blocks(gen, X.shape[0], b, iters)
    res_bcd = solve(X, y, lam, b, 1, iters, idx=idx, w_ref=w_opt, impl=impl)
    res_ca = solve(X, y, lam, b, s, iters, idx=idx, w_ref=w_opt,
                   track_cond=True, impl=impl)

    obj_bcd = res_bcd.history["objective"].cpu().numpy()
    obj_ca = res_ca.history["objective"].cpu().numpy()
    dev = float(np.max(np.abs(obj_ca - obj_bcd)))
    print(f"\nBCD      : {iters} iterations -> {iters} synchronizations")
    print(f"CA-BCD   : {iters} iterations -> {-(-iters // s)} "
          f"synchronizations (s={s}, one sb x sb Gram each)")
    print(f"max |objective difference| over the whole trajectory: {dev:.2e}")
    print(f"final solution error BCD    : "
          f"{float(res_bcd.history['sol_err'][-1]):.2e}")
    print(f"final solution error CA-BCD : "
          f"{float(res_ca.history['sol_err'][-1]):.2e}")
    cond = res_ca.history["gram_cond"].cpu().numpy()
    print(f"Gram condition numbers (s={s}): median {np.median(cond):.2f}, "
          f"max {np.max(cond):.2f}")
    if not dev < 1e-8:
        raise RuntimeError(f"CA-BCD must match BCD: deviation {dev:.2e}")
    print("\nsame iterates, 1/s the synchronizations -- the paper's claim.")
    return dev


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises without a card")
    ap.add_argument("--impl", default=None,
                    help="Gram-packet backend: ref | cuda (default: by device)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the data and the index stream")
    args = ap.parse_args()
    main(args.impl, seed=args.seed, device=args.device)
