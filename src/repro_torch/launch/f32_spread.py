"""How far f32 arithmetic alone spreads one train step: the dense decoder's
step in one process, run three times on the same weights and batch -- in
f32, in f32 with the batch's rows summed in two groups (two microbatches:
the sums regrouped as a grid's 'data' axis regroups them), and in f64 --
and each leaf's master move and m compared between the runs.

A grid's step regroups the one process's sums (rows over 'data', heads and
vocabulary columns over 'model').  Where the grid's f32 step is far from
the one process's, this says whether one process, regrouped, is as far
from itself (f32 rounding grown by the model: no fault of the grid), and
where both f32 runs stand against f64.  The weights are drawn as
``init_params`` draws them (the reference's init; ``--fan-in`` rescales
the attention projections to the fan-in of their contraction first).

Run on a GPU, from the repository root:
    PYTHONPATH=src python -m repro_torch.launch.f32_spread \\
        [--arch llama3_2_3b] [--layers 4] [--batch 4 512] [--seed 0] \\
        [--fan-in] [--out spread.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math

import torch

from repro_torch.models.module import tree_items, tree_map


def _fan_in(params: dict, cfg) -> None:
    """The attention projections rescaled, in place, to the fan-in of their
    contraction (d_model for wq / wk / wv, heads x head_dim for wo)."""
    for sub in params["blocks"].values():
        a = sub["attn"]
        for k in ("wq", "wk", "wv"):
            a[k].mul_(math.sqrt(a[k].shape[-2] / cfg.d_model))
        a["wo"].mul_(1 / math.sqrt(a["wo"].shape[-3]))


def _step(cfg, params: dict, batch: dict, microbatches: int) -> dict:
    """One train step from a fresh state on ``params`` (cloned): the
    metrics (the loss of the last microbatch), and the master's move and m
    of each leaf in f64."""
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    p = tree_map(torch.clone, params, torch.is_tensor)
    state = {"params": p, "opt": init_opt_state(p),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=batch["tokens"].device)}
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), microbatches)
    state, m = step(state, batch)
    before = dict(tree_items(params, torch.is_tensor))
    out = {"microbatches": microbatches,
           "metrics": {k: float(v) for k, v in m.items()},
           "move": {k: t.double() - before[k].double()
                    for k, t in tree_items(state["opt"]["master"],
                                           torch.is_tensor)},
           "m": {k: t.double()
                 for k, t in tree_items(state["opt"]["m"], torch.is_tensor)}}
    del state, step
    return out


def _rel(a, b) -> float:
    den = float(torch.linalg.vector_norm(b))
    return float(torch.linalg.vector_norm(a - b)) / den if den else 0.0


def compare(a: dict, b: dict) -> dict:
    """Each leaf's relative error of ``a`` against ``b`` (the master's move,
    m), the grad norm's and the loss's (``None`` where the two runs' losses
    are of other rows: their microbatches differ)."""
    same = a["microbatches"] == b["microbatches"]
    return {"loss": (abs(a["metrics"]["loss"] - b["metrics"]["loss"])
                     / abs(b["metrics"]["loss"]) if same else None),
            "grad_norm": abs(a["metrics"]["grad_norm"]
                             - b["metrics"]["grad_norm"])
            / abs(b["metrics"]["grad_norm"]),
            **{f"{name}/{k}": _rel(a[name][k], b[name][k])
               for name in ("move", "m") for k in b[name]}}


def spread(cfg, batch_shape: tuple, seed: int, device, fan_in: bool = False
           ) -> dict:
    """The three runs (module docstring) of ``cfg`` (its dtype ignored: f32
    and f64 copies are made) and their comparisons: ``{"metrics": {run:
    ...}, "regrouped_vs_f32", "f32_vs_f64", "regrouped_vs_f64"}``, each
    comparison a dict of :func:`compare`."""
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.models import api
    from repro_torch.models.module import init_params
    f32 = dataclasses.replace(cfg, dtype=torch.float32,
                              param_dtype=torch.float32)
    f64 = dataclasses.replace(cfg, dtype=torch.float64,
                              param_dtype=torch.float64)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(api.param_specs(f32), gen, device)
    if fan_in:
        _fan_in(params, f32)
    B, S = batch_shape
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             synthetic_lm_batch(cfg.vocab, S, B, seed=seed).items()}
    runs = {"f32": _step(f32, params, batch, 1),
            "regrouped": _step(f32, params, batch, 2)}
    runs["f64"] = _step(f64, tree_map(torch.Tensor.double, params,
                                      torch.is_tensor), batch, 1)
    return {"metrics": {k: r["metrics"] for k, r in runs.items()},
            "regrouped_vs_f32": compare(runs["regrouped"], runs["f32"]),
            "f32_vs_f64": compare(runs["f32"], runs["f64"]),
            "regrouped_vs_f64": compare(runs["regrouped"], runs["f64"])}


def worst(errors: dict, kind: str) -> tuple:
    """(leaf, error) of the largest ``kind`` ("move" or "m") error."""
    return max(((k.split("/", 1)[1], e) for k, e in errors.items()
                if k.startswith(kind + "/")), key=lambda kv: kv[1])


def main(argv=None) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data.regression import check_device
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_3b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, nargs=2, default=(4, 512))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fan-in", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = check_device(args.device)
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    out = spread(cfg, tuple(args.batch), args.seed, device, args.fan_in)
    out["config"] = {"arch": args.arch, "layers": args.layers,
                     "batch": list(args.batch), "seed": args.seed,
                     "fan_in": args.fan_in}
    for run, m in out["metrics"].items():
        print(f"[spread] {run}: loss {m['loss']!r} grad_norm "
              f"{m['grad_norm']!r}")
    for tag in ("regrouped_vs_f32", "f32_vs_f64", "regrouped_vs_f64"):
        e = out[tag]
        wk = {k: v for k, v in e.items() if k.endswith("attn/wk")}
        print(f"[spread] {tag}: loss rel {e['loss']!r}, grad norm rel "
              f"{e['grad_norm']!r}, worst move {worst(e, 'move')}, worst m "
              f"{worst(e, 'm')}, wk {wk}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
