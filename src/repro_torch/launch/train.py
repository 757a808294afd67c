"""Training launcher, the twin of ``repro.launch.train``: ``python -m
repro_torch.launch.train --arch qwen2_0_5b --preset cpu-small --steps
200``.

Presets size the run (the reference's, unchanged); ``--device cpu`` runs
on the CPU, and without a card the default device raises.  ``--mesh
auto`` trains on every local card (one nccl rank a card): laid out as the
reference lays out its devices (``train.elastic.plan_mesh``: tensor
parallelism over 'model' up to 16 wide, the rest over 'data') where the
config's family trains on that grid (``models.api.check_grid_family``),
else data-parallel on a 1-D world of ranks, as before the grid (MoE
experts sharded over the ranks); with one card (or on the CPU) it is the
single-device run.  ``--mesh DxM`` trains on a grid of D x M cards (with
``--device cpu``, of D x M gloo ranks on the CPU), and raises for a
family that grid does not run.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.grid import as_grid, grid_size
from repro_torch.data.regression import check_device
from repro_torch.models.api import check_grid_family
from repro_torch.train import Trainer, TrainRunConfig
from repro_torch.train.elastic import plan_mesh, run_data_parallel


PRESETS = {
    # ~10M params, runs on a CPU in minutes
    "cpu-small": dict(reduced=True, steps=200, global_batch=8, seq_len=256,
                      lr=1e-3, d_model=256, n_layers=4),
    # ~100M params: the end-to-end deliverable scale
    "100m": dict(reduced=True, steps=300, global_batch=32, seq_len=1024,
                 lr=6e-4, d_model=768, n_layers=12),
    # full published geometry
    "full": dict(reduced=False, steps=1000, global_batch=256, seq_len=4096,
                 lr=3e-4),
}


def build_model_cfg(arch: str, preset: dict):
    """The preset's model: the published config, or the reduced one at the
    preset's width (heads of 64) and depth (whole superblocks), with a
    quarter of the published vocabulary."""
    if not preset.get("reduced"):
        return get_config(arch)
    cfg = get_reduced(arch)
    kw = {}
    if "d_model" in preset:
        d = preset["d_model"]
        kw.update(d_model=d, d_ff=4 * d)
        if cfg.n_heads:
            kw.update(n_heads=max(d // 64, 1), head_dim=64,
                      n_kv_heads=max(min(cfg.n_kv_heads, d // 64), 1))
    if "n_layers" in preset:
        from repro_torch.models.api import _superblock_period
        period = _superblock_period(cfg)
        layers = max(preset["n_layers"] // period, 1) * period
        kw.update(n_layers=layers)
        if cfg.family == "audio":
            kw.update(enc_layers=layers)
    cfg = dataclasses.replace(cfg, **kw)
    return dataclasses.replace(cfg, vocab=get_config(arch).vocab // 4)


def choose_layout(model_cfg, mesh: str, n_cards: int) -> tuple:
    """``(ranks, grid, why)`` of a run of ``model_cfg`` under ``--mesh
    mesh`` with ``n_cards`` local cards (0 on the CPU): ``grid`` is
    ``None`` for one device, and for the 1-D data-parallel world that
    ``auto`` falls back to where ``plan_mesh``'s grid refuses the family
    (``why`` then says why); an explicit ``DxM`` grid that refuses the
    family raises."""
    if mesh == "none" or (mesh == "auto" and n_cards <= 1):
        return 1, None, ""
    if mesh == "auto":
        grid = plan_mesh(n_cards)
        try:
            check_grid_family(model_cfg, grid)
        except ValueError as e:
            return n_cards, None, f"1-D data-parallel world: {e}"
        return n_cards, grid, ""
    grid = as_grid(tuple(int(n) for n in mesh.split("x")))
    check_grid_family(model_cfg, grid)
    return grid_size(grid), grid, ""


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_0_5b")
    ap.add_argument("--preset", default="cpu-small", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mesh", default="none",
                    help="'none' (single device), 'auto' (all local cards "
                         "on plan_mesh's grid) or DxM (a grid of cards)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the data stream (fixed "
                         "default => reproducible loss trajectory)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises without a card")
    args = ap.parse_args(argv)

    device = check_device(args.device)
    preset = dict(PRESETS[args.preset])
    if args.steps:
        preset["steps"] = args.steps
    model_cfg = build_model_cfg(args.arch, preset)
    run_cfg = TrainRunConfig(
        steps=preset["steps"], global_batch=preset["global_batch"],
        seq_len=preset["seq_len"], lr=preset["lr"], ckpt_dir=args.ckpt_dir,
        seed=args.seed)
    ranks, grid, why = choose_layout(
        model_cfg, args.mesh,
        torch.cuda.device_count() if device.type == "cuda" else 0)
    from repro_torch.configs import n_params as npar
    print(f"[train] arch={model_cfg.name} params~{npar(model_cfg)/1e6:.1f}M "
          f"steps={run_cfg.steps} batch={run_cfg.global_batch} "
          f"seq={run_cfg.seq_len} device={device} ranks={ranks}"
          + ("" if grid is None else f" grid={grid}")
          + (f" ({why})" if why else ""))
    if ranks > 1:
        from repro_torch.core import SolverWorld
        backend = "nccl" if device.type == "cuda" else "gloo"
        with SolverWorld(ranks, backend=backend, device=device,
                         kernels=False) as world:
            hist = run_data_parallel(world, model_cfg, run_cfg,
                                     grid=grid)["history"]
    else:
        hist = Trainer(model_cfg, run_cfg, device=device).run()
    if hist:
        print(f"[train] loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
