"""Outputs of the sampled kernels and of the solves that run through them,
made from a seed and saved to a file; or two such files compared under
``torch.equal``.

For holding a change to a kernel against its parent commit on one card: run
this file (by its path: the parent need not have it) with ``--save`` once
with each commit's ``src`` on ``PYTHONPATH``, then ``--compare`` the two
files.  It imports ``repro_torch`` only from there.  Saved, on the real-sim
shape of the paper's Table 3 in f32 (X from ``make_regression`` at
``--seed``):

* K1's (G, r) at m = 8 and m = 128, with scale, reg and scale_r;
* K2's output at m = 8 and at CG's shape (flat = arange(d), m = d);
* K6's output at m = 128 (one vector);
* the primal single solves (CA-BCD) at s = 1 and s = 16 through the
  kernels, ``--iters`` iterations (w, alpha and the objective history);
* CG through the kernels (``impl="cuda"``): w and the iteration count;
* then, drawn after all of the above (so that the primal's index stream is
  the same with or without them): K3's (G, r) at m = 8 and m = 128, with
  scale, reg and scale_r; K4's output at m = 8 and 128; K5's output at
  m = 128 (one vector); the dual single solves (CA-BDCD) at s = 1 and
  s = 16 (w, alpha and the objective history).

Run on a GPU, from the repository root:
    PYTHONPATH=<commit>/src python src/repro_torch/launch/bitwise_outputs.py \\
        --save out.pt [--iters N] [--seed N]
    python src/repro_torch/launch/bitwise_outputs.py --compare a.pt b.pt
"""
from __future__ import annotations

import argparse
import sys

import torch


def outputs(iters: int, seed: int) -> dict:
    from repro_torch import core
    from repro_torch.data import PAPER_DATASETS_FULL, make_regression
    from repro_torch.data.regression import check_device
    from repro_torch.kernels import gram as gk

    dev = check_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    X, y, _ = make_regression(gen, PAPER_DATASETS_FULL["real-sim"],
                              torch.float32, device=dev)
    d, n = X.shape
    lam = 1e-6 * float(torch.linalg.norm(X) ** 2)
    out = {}
    for m in (8, 128):
        flat = torch.randperm(d, generator=gen, device=dev)[:m].to(
            torch.int32)
        flat[-1] = flat[0]                         # a duplicate index
        u = torch.randn((n,), generator=gen, device=dev)
        v = torch.randn((m,), generator=gen, device=dev)
        G, r = gk.gram_packet_sampled_rows(X, flat, u, scale=0.5, reg=0.25,
                                           scale_r=2.0)
        out[f"K1 G m={m}"], out[f"K1 r m={m}"] = G, r
        out[f"K2 m={m}"] = gk.panel_apply_rows(X, flat, v, scale=0.5)
        if m == 128:
            out[f"K6 m={m}"] = gk.panel_matvec_rows(X, flat, u)
    arange = torch.arange(d, dtype=torch.int32, device=dev)
    out["K2 CG shape"] = gk.panel_apply_rows(
        X, arange, torch.randn((d,), generator=gen, device=dev))
    idx = core.sample_blocks(gen, d, 8, iters)
    for s in (1, 16):
        res = core.ca_bcd(X, y, lam, 8, s, iters, idx=idx)
        out[f"primal s={s} w"], out[f"primal s={s} alpha"] = res.w, res.alpha
        out[f"primal s={s} objective"] = res.history["objective"]
    res = core.cg_ridge(X, y, lam, max_iters=100, impl="cuda")
    out["CG w"], out["CG iters"] = res.w, torch.tensor(res.iters)
    for m in (8, 128):
        flat = torch.randperm(n, generator=gen, device=dev)[:m].to(
            torch.int32)
        flat[-1] = flat[0]                         # a duplicate index
        u = torch.randn((d,), generator=gen, device=dev)
        v = torch.randn((m,), generator=gen, device=dev)
        G, r = gk.gram_packet_sampled_cols(X, flat, u, scale=0.5, reg=0.25,
                                           scale_r=2.0)
        out[f"K3 G m={m}"], out[f"K3 r m={m}"] = G, r
        out[f"K4 m={m}"] = gk.panel_apply_cols(X, flat, v, scale=0.5)
        if m == 128:
            out[f"K5 m={m}"] = gk.panel_matvec_cols(X, flat, u)
    idx = core.sample_blocks(gen, n, 8, iters)
    for s in (1, 16):
        res = core.ca_bdcd(X, y, lam, 8, s, iters, idx=idx)
        out[f"dual s={s} w"], out[f"dual s={s} alpha"] = res.w, res.alpha
        out[f"dual s={s} objective"] = res.history["objective"]
    torch.cuda.synchronize()
    return {key: val.cpu() for key, val in out.items()}


def compare(a: dict, b: dict) -> bool:
    same = True
    for key in sorted(set(a) | set(b)):
        eq = key in a and key in b and torch.equal(a[key], b[key])
        diff = (float((a[key].double() - b[key].double()).abs().max())
                if key in a and key in b and a[key].shape == b[key].shape
                else float("nan"))
        print(f"{key:24s} equal {eq}" + ("" if eq else f" (max |a - b| "
                                                        f"{diff:.3e})"))
        same &= eq
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--save", metavar="PATH")
    ap.add_argument("--compare", nargs=2, metavar="PATH")
    ap.add_argument("--iters", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.save:
        torch.save(outputs(args.iters, args.seed), args.save)
        print(f"saved {args.save}")
    if args.compare:
        a, b = (torch.load(path) for path in args.compare)
        if not compare(a, b):
            return 1
        print("all equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
