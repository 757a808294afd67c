"""Sparse recovery with CA proximal BCD (elastic net), the proximal
formulation's user entry point: the twin of ``examples/lasso.py``.

Solves   min_w 1/(2n) ||X^T w - y||^2 + lam/2 ||w||^2 + lam1 ||w||_1
through the same s-step engine as the ridge solvers (arXiv:1712.06047):
ONE sb x sb Gram packet per outer iteration, soft-threshold inside the
inner recurrence.  Shows
  1. identical trajectories for s = 1 and s > 1 (the CA claim survives the
     nonsmooth term), and
  2. support recovery: lam1 drives most coordinates to EXACT zeros while
     the synchronizations drop by s.

The data come from a numpy seed (X (256, 1024) standard normal in f64, a
16-sparse w_true, 2 % noise), so every package and device solves the same
problem; the index stream from a torch generator is shared by both solves.
On the card the packets and updates run through K1 / K2.

Run:  PYTHONPATH=src python -m repro_torch.launch.lasso
      [--device cuda|cpu] [--impl ref|cuda] [--seed N]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import elastic_net_objective, get_solver, sample_blocks
from repro_torch.data.regression import check_device

D, N, K = 256, 1024, 16          # K-sparse ground truth
LAM = 1e-4
ITERS, B, S = 600, 8, 20
TOL = 1e-8                       # the reference's bar between s = 1 and s


def problem(seed: int = 0) -> tuple:
    """(X (D, N), y (N,), w_true (D,), lam1) as numpy f64 arrays and the
    reference's l1 weight, 0.1 max |X y| / n."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((D, N))
    w_true = np.zeros(D)
    w_true[np.arange(K) * (D // K)] = 1.0
    y = X.T @ w_true + 0.02 * rng.standard_normal(N)
    lam1 = 0.1 * float(np.max(np.abs(X @ y)) / N)
    return X, y, w_true, lam1


def index_stream(seed: int = 0) -> torch.Tensor:
    """The (ITERS, B) block indices both solves share."""
    return sample_blocks(torch.Generator().manual_seed(seed + 2), D, B,
                         ITERS)


def main(impl: str | None = None, seed: int = 0, device="cuda") -> dict:
    """Both solves on one index stream; returns the largest objective
    deviation, the nnz, the recovered support and the outer steps."""
    device = check_device(device)
    solve = get_solver("proximal", "local")
    Xn, yn, w_true, lam1 = problem(seed)
    X = torch.from_numpy(Xn).to(device)
    y = torch.from_numpy(yn).to(device)
    print(f"problem: X {tuple(X.shape)} on {device}, ||w_true||_0 = {K}, "
          f"lam={LAM:.1e}, lam1={lam1:.3e}")
    idx = index_stream(seed).to(device)

    res_cl = solve(X, y, LAM, B, 1, ITERS, idx=idx, lam1=lam1, impl=impl)
    res_ca = solve(X, y, LAM, B, S, ITERS, idx=idx, lam1=lam1, impl=impl)

    dev = float(torch.max(torch.abs(res_ca.history["objective"]
                                    - res_cl.history["objective"])))
    nnz = int(res_ca.history["nnz"][-1])
    support = np.flatnonzero(res_ca.w.cpu().numpy())
    true_support = np.flatnonzero(w_true)
    recovered = len(np.intersect1d(support, true_support))
    outer = -(-ITERS // S)
    print(f"\nPBCD     : {ITERS} iterations -> {ITERS} synchronizations")
    print(f"CA-PBCD  : {ITERS} iterations -> {outer} synchronizations "
          f"(s={S}, soft-threshold inside the inner recurrence)")
    print(f"max |objective difference| over the trajectory: {dev:.2e}")
    print(f"final objective: "
          f"{float(elastic_net_objective(X, res_ca.w, y, LAM, lam1)):.4e}")
    print(f"sparsity: {nnz}/{D} nonzeros (true support {K}); "
          f"recovered {recovered}/{K} true coordinates")
    if not dev < TOL:
        raise RuntimeError(f"CA-PBCD must match classical proximal BCD: "
                           f"deviation {dev:.2e}")
    if not nnz < D // 2:
        raise RuntimeError(f"lam1 at this level must give a sparse iterate: "
                           f"{nnz} nonzeros")
    print("\nsame iterates, exact zeros, 1/s the synchronizations.")
    return {"deviation": dev, "nnz": nnz, "recovered": recovered,
            "syncs": {"classical": ITERS, "ca": outer},
            "w": res_ca.w, "w_classical": res_cl.w}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises without a card")
    ap.add_argument("--impl", default=None,
                    help="Gram-packet backend: ref | cuda (default: by "
                         "device)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the data (numpy) and the index stream")
    args = ap.parse_args()
    main(args.impl, seed=args.seed, device=args.device)
