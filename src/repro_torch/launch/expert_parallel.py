"""Experts sharded over a world of ranks: the MoE block, decode, serving
and one train step with one global dispatch (``models.moe``), each against
the same work in one process.

The ranks are a :class:`~repro_torch.core.world.SolverWorld` (gloo ranks
share the card or the CPU).  Weights, states and tokens reach them as the
world passes any argument: CUDA tensors by IPC (no copy), CPU tensors
through shared memory; each rank takes views of its experts
(``[r E / P, (r + 1) E / P)``) and copies only what it updates.

``chip_smoke.py`` (phase 15) and ``tests/test_torch_expert_parallel.py``
drive these functions.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from repro_torch.core.world import sync_device
from repro_torch.launch.flash_decode import _greedy, _release
from repro_torch.models import api, moe
from repro_torch.models.module import tree_map
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train.trainer import expert_shard_of, make_train_step


def _rows(t: torch.Tensor, comm) -> torch.Tensor:
    """Rank ``comm.rank``'s rows of a global batch (rank-major)."""
    n = t.shape[0] // comm.size
    return t[comm.rank * n:(comm.rank + 1) * n]


def _peak(device) -> int | None:
    return (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else None)


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


# ------------------------------------------------------------- the block --

def _block_rank(comm, device, *, cfg, params, x, replicated: bool,
                dy=None, reps: int = 1) -> dict:
    """One rank: views of its experts of the block's ``params`` (expert
    axis first), its rows of x (all of them when ``replicated``), ``reps``
    timed calls, each rank's record of the last one's calls (``Comm``'s
    and a ``collectives.WireTap``'s); with ``dy`` the gradients of
    ``sum(out * dy) + aux / P`` (a data-parallel loss that counts the aux
    loss once over the world)."""
    from repro_torch.core.collectives import WireTap
    lo, hi = moe.expert_range(cfg.moe.num_experts, comm.rank, comm.size)
    p = {k: (v[lo:hi] if k in moe.EXPERT_LEAVES else v).to(device)
         for k, v in params.items()}
    xs = (x if replicated else _rows(x, comm)).to(device)
    grad = dy is not None
    if grad:
        p = {k: v.detach().requires_grad_() for k, v in p.items()}
        xs = xs.detach().requires_grad_()
    secs, counters = [], []
    for _ in range(reps):
        comm.reset()
        sync_device(device)
        wire = WireTap()
        t0 = time.perf_counter()
        with torch.set_grad_enabled(grad), wire:
            out, metrics = moe.moe_block(p, xs, cfg, comm, replicated)
        sync_device(device)
        secs.append(time.perf_counter() - t0)
        counters.append(comm.counters())
    rec = {"out": out.detach().cpu(), "block_s": secs, "counters": counters,
           "metrics": {k: v.detach().cpu() for k, v in metrics.items()},
           "wire": wire.counters()}
    if grad:
        d = (dy if replicated else _rows(dy, comm)).to(device)
        ((out * d).sum() + metrics["moe_aux_loss"] / comm.size).backward()
        rec["grads"] = {"x": xs.grad.cpu(),
                        **{k: v.grad.cpu() for k, v in p.items()}}
    del p, xs, out
    _release(device)
    return rec


def ep_block(world, cfg, params, x, n_ranks: int, *, replicated=False,
             dy=None, reps: int = 1) -> dict:
    """The MoE block with its experts sharded over the first ``n_ranks``
    ranks of ``world``: ``params`` the whole block's (expert axis first),
    x (B, S, D) the global batch (each rank its B / P rows, or all of them
    when ``replicated``).  Returns the output (the ranks' rows joined, or
    rank 0's, which every rank's must equal), the metrics (the same bytes
    on every rank), each rank's ``Comm`` records and seconds a call, and
    with ``dy`` the gradients (x's rows and the experts joined, the
    router's summed over the ranks in rank order)."""
    outs = world.run(_block_rank, n_ranks, cfg=cfg, params=params, x=x,
                     replicated=replicated, dy=dy, reps=reps)
    first = outs[0]
    for r, o in enumerate(outs[1:], 1):
        if any(not torch.equal(o["metrics"][k], first["metrics"][k])
               for k in first["metrics"]):
            raise RuntimeError(f"rank {r}'s MoE metrics differ from rank 0's")
        if replicated and not torch.equal(o["out"], first["out"]):
            raise RuntimeError(f"rank {r}'s output differs from rank 0's")
    res = {"out": (first["out"] if replicated
                   else torch.cat([o["out"] for o in outs])),
           "metrics": first["metrics"],
           "counters": [o["counters"] for o in outs],
           "wire": [o["wire"] for o in outs],
           "block_s": [o["block_s"] for o in outs]}
    if dy is not None:
        gs = [o["grads"] for o in outs]
        router = gs[0]["router"]
        for g in gs[1:]:
            router = router + g["router"]
        res["grads"] = {"x": torch.cat([g["x"] for g in gs]),
                        "router": router,
                        **{k: torch.cat([g[k] for g in gs])
                           for k in moe.EXPERT_LEAVES}}
    return res


# --------------------------------------------------- decode and serving --

def _shard_params(params, comm, device) -> dict:
    """Views of the rank's experts of a stacked parameter tree, the rest
    whole, on ``device`` (copies only where the device changes)."""
    return tree_map(lambda t: t.to(device),
                    moe.cut_experts(params, comm.rank, comm.size),
                    is_leaf=torch.is_tensor)


def decode(model, cfg, tokens, steps: int, max_seq: int, feed=None,
           comm=None) -> dict:
    """Prefill ``tokens`` (B, S) then ``steps`` decode steps (greedy, or
    fed ``feed`` (B, steps)); with ``comm`` the model holds the rank's
    experts and every rank decodes the same tokens.  Returns the prefill's
    last logits and ``flash_decode._greedy``'s record."""
    with torch.no_grad():
        tokens = tokens.to(model.device)
        logits, cache = api.prefill(model, cfg, {"tokens": tokens},
                                    max_seq=max_seq, comm=comm,
                                    replicated=True)
        first = (logits[:, :cfg.vocab].argmax(-1) if feed is None
                 else feed[:, 0])
        S = tokens.shape[1]
        pos = torch.full((tokens.shape[0],), S, device=model.device)
        rec = _greedy(model, cfg, cache, first, pos, steps,
                      feed=None if feed is None else feed[:, 1:],
                      expert_comm=comm)
    rec["prefill"] = logits.float().cpu()
    return rec


def _decode_rank(comm, device, *, cfg, params, tokens, steps: int,
                 max_seq: int, feed=None, dtype=None) -> dict:
    shard = _shard_params(params, comm, device)
    if dtype is not None:       # leaf by leaf: no stacked copy of the shard
        cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
        shard = api._to_specs(shard, api.param_specs(cfg))
    model = api.build_model(cfg, shard)
    del shard
    out = decode(model, cfg, tokens, steps, max_seq, feed, comm)
    del model
    _release(device)
    return out


def ep_decode(world, cfg, params, tokens, steps: int, max_seq: int,
              n_ranks: int, *, feed=None, dtype=None) -> dict:
    """:func:`decode` of the model on ``params`` (the whole stacked tree)
    with its experts sharded over the first ``n_ranks`` ranks of
    ``world`` (``dtype``: each rank casts its shard).  Returns rank 0's
    record (every rank's tokens and logits must be the same bytes) with
    the slowest rank's seconds a step."""
    outs = world.run(_decode_rank, n_ranks, cfg=cfg, params=params,
                     tokens=tokens, steps=steps, max_seq=max_seq, feed=feed,
                     dtype=dtype)
    first = outs[0]
    for r, o in enumerate(outs[1:], 1):
        if not (torch.equal(o["logits"], first["logits"])
                and torch.equal(o["prefill"], first["prefill"])):
            raise RuntimeError(f"rank {r} decoded other logits than rank 0")
    out = dict(first)
    out["step_s"] = [max(o["step_s"][i] for o in outs) for i in range(steps)]
    return out


@contextlib.contextmanager
def moe_trace(rec: list):
    """While open, every MoE dispatch of this process appends to ``rec``, in
    call order and on the CPU, (name, tensor) for its input rows, router
    probabilities and top-k selection (``moe._route``), its experts' output
    buffer (``moe._experts``: the rank's experts only), and the slots it
    combines (all experts' after the all-gather) with the combined rows
    (``moe._combine``).  For locating where two runs' bits part."""
    route, experts, combine = moe._route, moe._experts, moe._combine

    def traced_route(p, xf, cfg):
        r = route(p, xf, cfg)
        rec.extend([("input", xf.cpu()), ("router probs", r["probs"].cpu()),
                    ("selection", r["sel"].cpu())])
        return r

    def traced_experts(p, buf):
        out = experts(p, buf)
        rec.append(("expert outputs", out.cpu()))
        return out

    def traced_combine(r, slot_out, K):
        out = combine(r, slot_out, K)
        rec.extend([("expert slots", slot_out.cpu()), ("combined", out.cpu())])
        return out

    moe._route, moe._experts, moe._combine = (traced_route, traced_experts,
                                              traced_combine)
    try:
        yield rec
    finally:
        moe._route, moe._experts, moe._combine = route, experts, combine


def _trace_rank(comm, device, *, cfg, params, tokens, steps: int,
                max_seq: int, feed=None) -> list:
    shard = _shard_params(params, comm, device)
    model = api.build_model(cfg, shard)
    del shard
    rec = []
    with moe_trace(rec):
        out = decode(model, cfg, tokens, steps, max_seq, feed, comm)
    del model
    _release(device)
    return rec + [("prefill logits", out["prefill"]),
                  ("decode logits", out["logits"])]


def first_difference(world, cfg, params, model, tokens, steps: int,
                     max_seq: int, n_ranks: int, *, feed=None) -> dict:
    """:func:`decode` on the ranks against one process (``model`` on the
    whole ``params``), every MoE tensor of :func:`moe_trace` in call order
    (each MoE layer of the prefill, then of each step) and the logits.  A
    rank's expert outputs are held to its experts' rows of the one
    process's.  Returns {"records": [(call, name, equal on every rank, max
    abs difference)], "first": the first record not equal, or None}."""
    one = []
    with moe_trace(one):
        out = decode(model, cfg, tokens, steps, max_seq, feed)
    one += [("prefill logits", out["prefill"]),
            ("decode logits", out["logits"])]
    ranks = world.run(_trace_rank, n_ranks, cfg=cfg, params=params,
                      tokens=tokens, steps=steps, max_seq=max_seq, feed=feed)
    E = cfg.moe.num_experts
    El = E // n_ranks
    records, calls = [], 0
    for i, (name, want) in enumerate(one):
        calls += name == "input"
        equal, worst = True, 0.0
        for r, rec in enumerate(ranks):
            got = rec[i][1]
            w = want
            if name == "expert outputs":   # (E C, D): the rank's E / P
                w = want.reshape(E, -1, want.shape[-1])[
                    r * El:(r + 1) * El].reshape(got.shape)
            equal &= torch.equal(got, w)
            worst = max(worst, float((got.double() - w.double()).abs().max()))
        records.append((calls, name, equal, worst))
    first = next((rec for rec in records if not rec[2]), None)
    return {"records": records, "first": first}


def _serve_rank(comm, device, *, cfg, params, prompts, new: int,
                serve: ServeConfig) -> list:
    model = api.build_model(cfg, _shard_params(params, comm, device))
    with torch.no_grad():
        out = Engine(cfg, model, serve, comm=comm).generate(prompts, new)
    del model
    _release(device)
    return out


def ep_serve(world, cfg, params, prompts, new: int, serve: ServeConfig,
             n_ranks: int) -> list:
    """``Engine(..., comm=...)`` on the first ``n_ranks`` ranks, each
    holding its experts, every rank given the same requests: rank 0's
    generated tokens (every rank's must be the same)."""
    outs = world.run(_serve_rank, n_ranks, cfg=cfg, params=params,
                     prompts=prompts, new=new, serve=serve)
    if any(o != outs[0] for o in outs[1:]):
        raise RuntimeError("the ranks generated different tokens")
    return outs[0]


# ------------------------------------------------------------- training --

def _leaf_items(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_items(tree[k], path + (k,))
    else:
        yield path, tree


def _train_rank(comm, device, *, cfg, params, batch, lr: float, want=None,
                keep: bool = False, steps: int = 1) -> dict:
    """One rank: a fresh train state of its cut of ``params`` (the whole
    tree: master = the parameters in f32, m = v = 0, step 0), the MoE
    metrics of a forward on its rows, then ``steps`` ``make_train_step``
    steps on the global ``batch``.  The first step's metrics, and against
    ``want`` (``{"master"[, "m"]}``, the whole trees after the same first
    step in one process, on any device) each leaf's difference: the
    master's relative to the leaf's move, m's to its norm; each step's
    seconds, the last one's ``Comm`` record and allocator peak."""
    shard = expert_shard_of(cfg, comm)
    if shard:
        params = moe.cut_experts(params, *shard)
    p = tree_map(lambda t: t.to(device, copy=True), params,
                 is_leaf=torch.is_tensor)
    st = {"params": p, "opt": init_opt_state(p),
          "step": torch.zeros((), dtype=torch.int32, device=device)}
    rows = {k: _rows(torch.as_tensor(v), comm).to(device)
            for k, v in batch.items()}
    with torch.no_grad():
        _, fwd = api.forward(api.build_model(cfg, p), cfg, rows,
                             comm if shard else None)
    step = make_train_step(cfg, AdamWConfig(lr=lr), comm=comm)
    rec = {"forward": {k: float(v) for k, v in fwd.items()}, "step_s": []}
    for i in range(steps):
        comm.reset()
        sync_device(device)
        _reset_peak(device)
        t0 = time.perf_counter()
        st, metrics = step(st, batch)
        sync_device(device)
        rec["step_s"].append(time.perf_counter() - t0)
        if i == 0:
            rec["metrics"] = {k: float(v) for k, v in metrics.items()}
            if want is not None:
                rec["err"] = _errors(st["opt"], want, params, shard, device)
            if keep:
                rec["state"] = tree_map(lambda t: t.detach().cpu(), st,
                                        is_leaf=torch.is_tensor)
    rec.update(peak_bytes=_peak(device), counters=comm.counters())
    del st, p
    _release(device)
    return rec


def _errors(opt, want, start, shard, device) -> dict:
    """Each leaf's difference from ``want`` (whole trees; ``shard``: the
    rank's cut of the experts): the master's relative to the leaf's move
    from ``start``, m's relative to its norm."""
    errs = {}
    for name in want:
        ref_tree = moe.cut_experts(want[name], *shard) if shard \
            else want[name]
        for (path, got), (_, w), (_, s0) in zip(
                _leaf_items(opt[name]), _leaf_items(ref_tree),
                _leaf_items(start)):
            w = w.to(device)
            ref = (w - s0.to(device, torch.float32)) if name == "master" \
                else w
            errs[name + "/" + "/".join(path)] = float(
                torch.linalg.norm((got - w).double())) / max(
                float(torch.linalg.norm(ref.double())), 1e-30)
    return errs


def ep_train_step(world, cfg, params, batch, n_ranks: int, *, lr: float,
                  want=None, keep: bool = False, steps: int = 1) -> dict:
    """``steps`` train steps from a fresh state of ``params`` (the whole
    tree) on the global ``batch`` with the experts sharded over the first
    ``n_ranks`` ranks of ``world`` (:func:`_train_rank`).  Returns rank
    0's first-step metrics and forward MoE metrics (the loss, aux loss,
    drop fraction and grad norm are the same on every rank), each rank's
    seconds a step, last ``Comm`` record and allocator peak, against
    ``want`` each leaf's error (the largest over the ranks), and with
    ``keep`` the ranks' states after the first step joined into the whole
    tree (on the CPU)."""
    from repro_torch.interop import join_expert_shards
    outs = world.run(_train_rank, n_ranks, cfg=cfg, params=params,
                     batch=batch, lr=lr, want=want, keep=keep, steps=steps)
    for r, o in enumerate(outs[1:], 1):
        if o["metrics"] != outs[0]["metrics"] or \
                o["forward"] != outs[0]["forward"]:
            raise RuntimeError(f"rank {r}'s step metrics differ from rank "
                               f"0's: {o['metrics']} / {outs[0]['metrics']}")
    res = {"metrics": outs[0]["metrics"], "forward": outs[0]["forward"],
           "step_s": [o["step_s"] for o in outs],
           "counters": [o["counters"] for o in outs],
           "peak_bytes": [o["peak_bytes"] for o in outs]}
    if want is not None:
        res["err"] = {k: max(o["err"][k] for o in outs)
                      for k in outs[0]["err"]}
    if keep:
        res["state"] = join_expert_shards([o["state"] for o in outs])
    return res


def _state_rank(comm, device, *, cfg, state_np) -> dict:
    from repro_torch.interop import (train_state_from_reference,
                                     train_state_to_numpy)
    state = train_state_from_reference(state_np, cfg, device=device,
                                       expert_shard=expert_shard_of(cfg,
                                                                    comm))
    return train_state_to_numpy(state, comm)


def gathered_state(world, cfg, state_np, n_ranks: int) -> list:
    """A reference train state (numpy) cut into each rank's expert shard
    (``interop.train_state_from_reference``) and gathered back whole to
    rank 0's host (``interop.train_state_to_numpy(state, comm)``): each
    rank's result (the whole tree on rank 0, ``None`` on the others)."""
    return world.run(_state_rank, n_ranks, cfg=cfg, state_np=state_np)
