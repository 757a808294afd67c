"""Training on a grid of ranks: the train step of the reference's production
layout (tensor parallelism over 'model', ZeRO-1 over 'data', FSDP with
``cfg.fsdp``; ``train.trainer``) from given weights and a given batch,
against the same step in one process.

The ranks are a :class:`~repro_torch.core.world.SolverWorld` laid out by
``run_grid``; weights and batches reach them as the world passes any
argument (CUDA tensors by IPC, CPU tensors through shared memory), and
each rank copies its blocks of them (``train.trainer.place_fresh``).
``chip_smoke.py`` (phase 16) and ``tests/test_torch_grid_train.py`` drive
these functions; spawned ranks import them from here.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core.world import sync_device
from repro_torch.launch.flash_decode import _release
from repro_torch.models.module import tensor_leaves, tree_items, tree_map
from repro_torch.models.sharding import cut, spec_axes
from repro_torch.optim import AdamWConfig
from repro_torch.train.trainer import (gather_state, make_train_step,
                                       place_fresh, train_step_shardings)


def _rank_steps(comm, device, *, cfg, params, batch, steps: int, lr: float,
                keep: bool, want=None) -> dict:
    """One rank: its blocks of a fresh state on ``params``, ``steps`` train
    steps on ``batch`` (each timed, the collectives' host seconds and
    counts of the last), the allocator's peak on CUDA, the assembled
    state on rank 0 with ``keep``, and with ``want`` (another run's
    ``{"master", "m"}`` after the first step) its blocks' error terms
    after the first step (:func:`_error_terms`) and the master blocks
    the step left as they were (``still``)."""
    cuda = torch.device(device).type == "cuda"
    state = place_fresh(params, cfg, comm)
    step = make_train_step(cfg, AdamWConfig(lr=lr), comm=comm)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    secs, metrics, out = [], [], {}
    for i in range(steps):
        comm.reset()
        sync_device(device)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync_device(device)
        secs.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        if want is not None and i == 0:
            out["err"], out["still"] = _error_terms(state, want, params, cfg,
                                                    comm)
    out.update({"metrics": metrics[-1], "first": metrics[0],
           "step_s": secs, "counters": comm.counters(),
           "host_s": comm.host_s(), "coords": comm.coords,
           "peak_bytes": (torch.cuda.max_memory_allocated(device)
                          if cuda else None),
           "opt_bytes": sum(t.numel() * t.element_size()
                            for t in tensor_leaves(state["opt"]))})
    whole = gather_state(state, cfg, comm) if keep else None
    if comm.rank == 0:
        out["state"] = whole
    del state
    _release(device)
    return out


def _error_terms(state, want, params, cfg, comm) -> tuple:
    """``{"master/<leaf>": (|move - want's move|^2, |want's move|^2),
    "m/<leaf>": (|m - want|^2, |want|^2)}`` over the rank's optimizer
    blocks that count (one rank of those holding the same block), the
    moves from ``params`` in f32: summed over the ranks, the whole
    leaves' squared errors and norms; and the leaves whose master block
    did not move on this rank."""
    shardings, _ = train_step_shardings(cfg, comm.grid)
    out, still = {}, []
    for name in ("master", "m"):
        mine = dict(tree_items(state["opt"][name], torch.is_tensor))
        specs = dict(tree_items(shardings["opt"][name], torch.is_tensor))
        for k, spec in specs.items():
            if not all(comm.coords[a] == 0 for a, n in comm.grid.items()
                       if n > 1 and a not in spec_axes(spec)):
                continue
            w = cut(_at(want[name], k), spec,
                    comm.grid, comm.coords).to(mine[k].device, torch.float64)
            g = mine[k].to(torch.float64)
            if name == "master":
                b = cut(_at(params, k), spec, comm.grid, comm.coords).to(
                    g.device, torch.float32).to(torch.float64)
                g, w = g - b, w - b
                if not bool(g.any()):
                    still.append(k)
            out[f"{name}/{k}"] = (float(torch.sum((g - w) ** 2)),
                                  float(torch.sum(w ** 2)))
    return out, still


def _at(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def combine_errors(terms: list) -> dict:
    """The ranks' :func:`_error_terms` summed: each leaf's relative error
    (the move's for the master, m's against its norm)."""
    num, den = {}, {}
    for t in terms:
        for k, (a, b) in t.items():
            num[k] = num.get(k, 0.0) + a
            den[k] = den.get(k, 0.0) + b
    return {k: (num[k] / den[k]) ** 0.5 if den[k] else num[k] ** 0.5
            for k in num}


def grid_train_steps(world, grid, cfg, params: dict, batch: dict, *,
                     steps: int = 1, lr: float = 1e-3, keep: bool = True,
                     want: dict | None = None) -> dict:
    """``steps`` train steps of ``cfg`` on ``grid`` (the first ranks of
    ``world``) from the whole parameter tree ``params`` (a fresh state:
    master = params in f32, zero moments, step 0) on the global ``batch``
    every step.  Returns rank 0's ``metrics`` (the last step's loss,
    grad_norm, lr) and ``first`` (the first step's), its ``state`` (the
    whole tree on the CPU, with ``keep``), and for each rank its
    ``step_s``, ``counters`` (a ``Comm`` record per group), ``host_s``
    (seconds in its collectives, last step), ``peak_bytes`` (CUDA) and
    ``opt_bytes``; with ``want`` (the one-process ``{"master", "m"}``
    after the first step) each leaf's relative error after the first
    step, ``err`` (:func:`combine_errors`: the master's move, m against
    its norm), computed on the ranks' blocks, and ``still``, the leaves
    of which some rank's master block did not move."""
    outs = world.run_grid(_rank_steps, grid, cfg=cfg, params=params,
                          batch=batch, steps=steps, lr=lr, keep=keep,
                          want=want)
    return {"metrics": outs[0]["metrics"], "first": outs[0]["first"],
            "state": outs[0].get("state"),
            "err": (None if want is None
                    else combine_errors([o["err"] for o in outs])),
            "still": (None if want is None else
                      sorted({k for o in outs for k in o["still"]})),
            **{k: [o[k] for o in outs] for k in (
                "step_s", "counters", "host_s", "peak_bytes", "opt_bytes",
                "coords")}}


def one_process_steps(cfg, params: dict, batch: dict, *, steps: int = 1,
                      lr: float = 1e-3) -> tuple:
    """The same steps in this process on ``params``' device: (the last
    step's metrics as floats, the state, each step's seconds)."""
    from repro_torch.optim import init_opt_state
    dev = tensor_leaves(params)[0].device
    p = tree_map(torch.clone, params, torch.is_tensor)
    state = {"params": p, "opt": init_opt_state(p),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    step = make_train_step(cfg, AdamWConfig(lr=lr))
    secs, metrics = [], None
    for _ in range(steps):
        sync_device(dev)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        sync_device(dev)
        secs.append(time.perf_counter() - t0)
    return {k: float(v) for k, v in metrics.items()}, state, secs


def _rank_restore(comm, device, *, cfg, run_cfg) -> dict:
    """One rank: a Trainer on the grid restored from ``run_cfg.ckpt_dir``
    (no step taken); the assembled state on rank 0."""
    from repro_torch.train import Trainer
    trainer = Trainer(cfg, run_cfg, comm)
    out = {"step": int(trainer.state["step"]),
           "state": trainer.logical_state()}
    del trainer
    _release(device)
    return out


def restore_on_grid(world, grid, cfg, run_cfg) -> dict:
    """The newest checkpoint of ``run_cfg.ckpt_dir`` restored on ``grid``
    (each rank cuts its blocks of the logical tree), assembled again on
    rank 0: ``{"step", "state"}``."""
    return world.run_grid(_rank_restore, grid, cfg=cfg, run_cfg=run_cfg)[0]


def _block_digests(state, cfg, comm, cut_blocks: bool,
                   prefix: str = "") -> list:
    """SHA-256 of each leaf's block at the rank's coordinates (cut from a
    whole replicated state with ``cut_blocks``), leaves in tree order;
    only the leaves whose path starts with ``prefix``."""
    import hashlib
    shardings, _ = train_step_shardings(cfg, comm.grid)
    specs = dict(tree_items(shardings, torch.is_tensor))
    out = []
    for k, t in tree_items(state, torch.is_tensor):
        if not k.startswith(prefix):
            continue
        if cut_blocks:
            t = cut(t, specs[k], comm.grid, comm.coords)
        h = hashlib.sha256(t.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes())
        out.append((k, h.hexdigest()))
    return out


def _rank_zero1_vs_replicated(comm, device, *, cfg, run_cfg) -> dict:
    """One rank: the Trainer on the grid's ranks as a replicated
    data-parallel world (``comm.world``), its state's blocks at the rank's
    coordinates digested, then the Trainer on the grid (ZeRO-1), its
    blocks digested; each run's history, optimizer bytes and peak, and
    the digests of its master blocks before the run (``start``: a step
    that moved them changes every one)."""
    from repro_torch.train import Trainer
    cuda = torch.device(device).type == "cuda"
    out = {}
    for tag, c in (("replicated", comm.world), ("grid", comm)):
        _release(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        trainer = Trainer(cfg, run_cfg, c)
        start = _block_digests(trainer.state, cfg, comm,
                               cut_blocks=tag == "replicated",
                               prefix="opt/master/")
        sync_device(device)
        t0 = time.perf_counter()
        history = trainer.run()
        sync_device(device)
        secs = time.perf_counter() - t0
        out[tag] = {
            "history": history, "run_s": secs, "start": start,
            "digests": _block_digests(trainer.state, cfg, comm,
                                      cut_blocks=tag == "replicated"),
            "opt_bytes": sum(t.numel() * t.element_size()
                             for t in tensor_leaves(trainer.state["opt"])),
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if cuda else None)}
        del trainer
    _release(device)
    return out


def zero1_against_replicated(world, grid, cfg, run_cfg) -> list:
    """``run_cfg``'s run on ``grid`` (ZeRO-1; every rank's Trainer) and on
    the same ranks as the replicated data-parallel world, each rank's
    blocks of the two states digested where they lie (no state leaves
    its rank): the ranks' records (:func:`_rank_zero1_vs_replicated`)."""
    return world.run_grid(_rank_zero1_vs_replicated, grid, cfg=cfg,
                          run_cfg=run_cfg)
