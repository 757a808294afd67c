"""Serving launcher: batched generation over the slot engine, the twin of
``repro.launch.serve``.

``python -m repro_torch.launch.serve --arch llama3_2_3b --requests 6
--max-new 16`` serves the reduced configuration on the card; ``--full``
serves the published one (random weights from ``--seed``: no weights are
downloaded); ``--device cpu`` runs on the CPU.  Without a card the default
device raises.  Every decoder family's ``--arch`` is served (dense, vlm,
ssm, hybrid, moe; the ssm / hybrid prompts are one SSD chunk long); the
encoder-decoder (seamless) is refused by the engine, whose requests carry
no encoder frames.

``--mesh`` lays the ranks out as ``launch.train`` does
(``launch.train.choose_layout``): ``none`` serves on one device, ``DxM`` on
a grid of D x M ranks in the reference's production layout (one nccl rank
a card; with ``--device cpu`` gloo ranks on the CPU; the dense decoder,
the vlm and the ssm family where M > 1, ``models.api.check_grid_family``,
else it raises),
``auto`` on ``plan_mesh``'s grid of every local card where the family
runs on it, else on one card (the line says why).  ``--seq-shard-decode
true|false`` is the reference dry run's flag: the decode cache's positions
cut over 'model' (default) or its kv heads.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.data.regression import check_device
from repro_torch.launch.train import choose_layout
from repro_torch.models import api
from repro_torch.models.module import init_params
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.engine import check_served


def main(argv=None) -> list[list[int]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_3b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, the prompts and the sampling "
                         "stream (fixed default => reproducible outputs)")
    ap.add_argument("--full", action="store_true",
                    help="the published configuration, not the reduced one")
    ap.add_argument("--mesh", default="none",
                    help="'none' (one device), 'auto' (every local card on "
                         "plan_mesh's grid) or DxM (a grid of ranks)")
    ap.add_argument("--seq-shard-decode", default="true",
                    choices=["true", "false"],
                    help="cut the decode cache's positions over 'model' "
                         "(true) or its kv heads (false)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises without a card")
    args = ap.parse_args(argv)

    device = check_device(args.device)
    cfg = (get_config if args.full else get_reduced)(args.arch)
    check_served(cfg)               # before any rank starts
    ranks, grid, why = choose_layout(
        cfg, args.mesh,
        torch.cuda.device_count() if device.type == "cuda" else 0)
    if grid is None and ranks > 1:
        why, ranks = f"one device: {why}", 1
    seq_shard = args.seq_shard_decode == "true"
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(api.param_specs(cfg), gen, device)
    serve = ServeConfig(max_seq=512, slots=args.slots,
                        temperature=args.temperature, seed=args.seed)

    rng = np.random.default_rng(args.seed)
    chunk = cfg.ssm.chunk if cfg.ssm else 8
    prompts = [list(rng.integers(1, cfg.vocab, size=chunk))
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    if ranks > 1:
        from repro_torch.core import SolverWorld
        from repro_torch.launch.grid_serve import grid_engine
        backend = "nccl" if device.type == "cuda" else "gloo"
        with SolverWorld(ranks, backend=backend, device=device,
                         kernels=False) as world:
            outs = grid_engine(world, grid, cfg, params, prompts,
                               args.max_new, serve,
                               seq_shard=seq_shard)[0]["outs"]
    else:
        outs = Engine(cfg, api.build_model(cfg, params), serve).generate(
            prompts, args.max_new)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    print(f"[serve] {cfg.name} on {device}: {args.requests} requests x "
          f"{args.max_new} tokens in {dt:.2f}s ({total / dt:.1f} tok/s "
          f"aggregate, {args.slots} slots)"
          + ("" if grid is None else f", grid {grid}, seq_shard {seq_shard}")
          + (f" ({why})" if why else ""))
    for i, o in enumerate(outs[:4]):
        print(f"  req{i}: {o[:12]}{'...' if len(o) > 12 else ''}")
    return outs


if __name__ == "__main__":
    main()
