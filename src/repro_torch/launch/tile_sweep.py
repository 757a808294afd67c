"""Sweep the contraction chunk ``bk`` of the packet kernels K1 and K3 on the
card, at the solve's shapes (real-sim: d = 20958, n = 72309, f32).

Prints, per (kernel, m, bk), the device time of one packet and the number of
blocks it launches, with the default pick of ``tuning.pick_tiles`` marked.
The data are Gaussian: a packet's time does not depend on X's values.

Run on a GPU:  PYTHONPATH=src python -m repro_torch.launch.tile_sweep
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.data.regression import check_device
from repro_torch.kernels import gram as gk
from repro_torch.kernels.gram import tuning
from repro_torch.launch.timing import KERNEL_NAMES, device_ms

CHUNKS = (256, 512, 1024, 1536, 2048, 3072, 4096, 8192)


def main(d: int = 20958, n: int = 72309, reps: int = 20, seed: int = 0):
    dev = check_device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((d, n), generator=g, device=dev)
    rows = []
    for kern, layout, S, K in ((gk.gram_packet_sampled_rows, "rows", d, n),
                               (gk.gram_packet_sampled_cols, "cols", n, d)):
        u = torch.randn((K,), generator=g, device=dev)
        for m in (8, 128):
            flat = torch.randperm(S, generator=g, device=dev)[:m].to(
                torch.int32)
            auto = tuning.pick_tiles(m, K, X.dtype, layout)
            for bk in sorted(set(CHUNKS) | {auto}):
                ms = device_ms(lambda: kern(X, flat, u, bk=bk), reps,
                               KERNEL_NAMES["packet"])
                blocks = tuning.lower_tiles(m) * -(-K // bk)
                mark = "  <- default" if bk == auto else ""
                print(f"{kern.__name__:26s} m={m:4d} bk={bk:5d} "
                      f"blocks={blocks:5d}: {ms:.4f} ms{mark}", flush=True)
                rows.append((layout, m, bk, ms))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    main(reps=args.reps)
