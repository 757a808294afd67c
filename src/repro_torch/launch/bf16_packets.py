"""Device times of the bf16 Gram packets K1, K7 and K3 (bf16 X and u, f32
outputs) on the real-sim X cast to bf16, at the solve's m = 128 and 8, on
inputs drawn from a seed alone.

It calls only the packets' public wrappers, so it runs against any tree of
the port: run this file by its path with that tree's ``src`` on
``PYTHONPATH`` (the tree builds its own kernels), once per design, and two
designs are timed on the same X, indices and u.  ``chip_smoke.py`` phase
2c draws its inputs here and, given ``--parent``, times the parent commit's
packets through this file in turns with its own.  On a GPU machine, from
the repository root:

    PYTHONPATH=<tree>/src python src/repro_torch/launch/bf16_packets.py \\
        --seed 0 --reps 50

prints one JSON object, {"rows" | "dense" | "cols": {m: device ms}}.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import core
from repro_torch.kernels import gram as gk
from repro_torch.launch.timing import device_ms

MS = (128, 8)
# either design's kernels: the f32-ring tile (dense_tile) or the tensor-core
# tile (mma_tile), and the reduce pass
NAMES = ("dense_tile", "mma_tile", "dense_reduce")


def blocked_flat(gen, n_total: int, b: int, blocks: int):
    """``blocks`` blocks of ``b`` distinct indices each, with duplicates
    across blocks forced in: the index pattern of one outer step."""
    idx = core.sample_blocks(gen, n_total, b, blocks)
    for k in range(1, blocks):
        prev = idx[k - 1, 0]
        if not bool((idx[k] == prev).any()):
            idx[k, -1] = prev              # a duplicate across blocks
    return idx.reshape(-1).contiguous()


def real_sim(seed: int, device) -> torch.Tensor:
    """The real-sim X (20958 x 72309, f32), as ``chip_smoke.py`` draws it
    first from its generator."""
    from repro_torch.data import PAPER_DATASETS_FULL, make_regression
    gen = torch.Generator(device=device).manual_seed(seed)
    X, _, _ = make_regression(gen, PAPER_DATASETS_FULL["real-sim"],
                              torch.float32, device=device)
    return X


def cases(Xb: torch.Tensor, seed: int) -> list:
    """Per m in :data:`MS`: row indices (blocks of 8 over d) with u (n,),
    column indices (blocks of 8 over n) with u (d,), from a generator of
    their own."""
    d, n = Xb.shape
    gen = torch.Generator(device=Xb.device).manual_seed(seed + 2)
    out = []
    for m in MS:
        flat = blocked_flat(gen, d, 8, m // 8)
        u = torch.randn((n,), generator=gen, device=Xb.device,
                        dtype=torch.bfloat16)
        flat_c = blocked_flat(gen, n, 8, m // 8)
        u_c = torch.randn((d,), generator=gen, device=Xb.device,
                          dtype=torch.bfloat16)
        out.append({"m": m, "flat": flat, "u": u, "flat_c": flat_c,
                    "u_c": u_c})
    return out


def calls(Xb: torch.Tensor, case: dict) -> dict:
    """The three packets on one case, as the public wrappers launch them
    (K7 on the gathered rows X[flat])."""
    Y = Xb[case["flat"].long()].contiguous()
    return {"rows": lambda: gk.gram_packet_sampled_rows(Xb, case["flat"],
                                                        case["u"]),
            "dense": lambda: gk.gram_packet_dense(Y, case["u"]),
            "cols": lambda: gk.gram_packet_sampled_cols(Xb, case["flat_c"],
                                                        case["u_c"])}


def times(Xb: torch.Tensor, cs: list, reps: int) -> dict:
    """{"rows" | "dense" | "cols": {m: device ms of one call}}."""
    out = {"rows": {}, "dense": {}, "cols": {}}
    for case in cs:
        for name, fn in calls(Xb, case).items():
            out[name][case["m"]] = device_ms(fn, reps, NAMES)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bf16_packets: needs a CUDA device")
    Xb = real_sim(args.seed, torch.device("cuda")).to(torch.bfloat16)
    print(json.dumps(times(Xb, cases(Xb, args.seed), args.reps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
