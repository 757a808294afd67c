"""Serving on a grid of ranks: prefill, decode steps and the engine of the
reference's production layout (tensor parallelism over 'model', the slots
over (pod, data), the decode cache cut as ``launch.inputs.decode_specs``
cuts it; ``models.api``'s grid section, ``serve.engine``) from given
weights, against the same calls in one process.

The ranks are a :class:`~repro_torch.core.world.SolverWorld` laid out by
``run_grid``; weights and prompts reach them as the world passes any
argument (CUDA tensors by IPC, CPU tensors through shared memory), and
each rank copies its blocks (``api.grid_model``).  ``chip_smoke.py``
(phase 17), ``launch/serve.py --mesh`` and ``tests/test_torch_grid_serve.py``
drive these functions; spawned ranks import them from here.

A run of :func:`grid_serve` prefills prompts right-padded to one length
(row b's ``lens[b]`` tokens are real) and decodes ``steps`` tokens: step 0
replays each row's last prompt token at ``lens - 1`` (as the engine does),
step t feeds ``feed[t]`` (another run's tokens, so that two runs' logits
stay comparable) or the run's own greedy token.  ``embeds`` feeds the
frontend's embeddings with the tokens: the audio family's encoder frames
(``src_embeds``), the vlm's patch prefix (``extra_embeds``, whose
positions come before the prompt's: a row's positions are shifted by the
prefix's length).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core.grid import as_grid
from repro_torch.core.world import sync_device
from repro_torch.launch.flash_decode import _release
from repro_torch.launch.inputs import tree_bytes
from repro_torch.models import api
from repro_torch.models.module import tree_map
from repro_torch.models.sharding import (assemble, assemble_tree, cut,
                                         make_rules)
from repro_torch.serve import Engine
from repro_torch.serve.engine import RECURRENT, sample_tokens
from repro_torch.serve.slots import bucket_pow2
from repro_torch.train.trainer import frontend_key


def rank_rows(t: torch.Tensor, comm) -> torch.Tensor:
    """The rank's rows of a (B, ...) tensor: its block over (pod, data)."""
    spec = make_rules(comm.grid).spec_for(
        tuple(t.shape), ("batch",) + (None,) * (t.dim() - 1))
    return cut(t, spec, comm.grid, comm.coords)


def _first_layer(cache: dict) -> dict:
    """The stacked leaves of a cache's first (or only) group of layers."""
    return cache["decoder"] if "decoder" in cache else cache["blocks"]["sub0"]


def _greedy(model, logits, vocab: int) -> torch.Tensor:
    lay = model.layout
    if lay is not None:
        return lay.greedy(logits, vocab)
    return torch.argmax(logits[:, :vocab], dim=-1)


def _param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _serve_loop(model, cfg, tokens, lens, max_seq: int, steps: int, feed,
                seq_shard: bool, device, comm=None, embeds=None) -> dict:
    """Prefill and ``steps`` decode steps of ``model`` (module docstring),
    each timed; with ``comm`` (a ``GridComm``) the collectives of the
    last step by group and their host seconds, and the prefill's."""
    out = {"logits": [], "picks": [], "fed": [], "step_s": []}
    batch, off, enc_len = {"tokens": tokens}, 0, None
    if embeds is not None:
        batch[frontend_key(cfg)] = embeds
        if cfg.family == "vlm":             # the prefix's positions first
            off = embeds.shape[1]
        else:
            enc_len = embeds.shape[1]
    with torch.no_grad():
        if comm is not None:
            comm.reset()
        sync_device(device)
        t0 = time.perf_counter()
        logits, cache = api.prefill(model, cfg, batch, max_seq=max_seq,
                                    seq_shard=seq_shard)
        sync_device(device)
        out["prefill_s"] = time.perf_counter() - t0
        if comm is not None:
            out["prefill_calls"] = comm.counters()
        out["logits"].append(logits.cpu())
        rows = torch.arange(tokens.shape[0], device=device)
        cur = tokens[rows, lens - 1]
        for t in range(steps):
            if t and feed is not None:
                cur = feed[t]
            if comm is not None:
                comm.reset()
            sync_device(device)
            t0 = time.perf_counter()
            logits, cache = api.decode_step(model, cfg, cache, cur,
                                            off + lens - 1 + t,
                                            seq_shard=seq_shard,
                                            enc_len=enc_len)
            sync_device(device)
            out["step_s"].append(time.perf_counter() - t0)
            if comm is not None:
                out["calls"], out["host_s"] = comm.counters(), comm.host_s()
            out["fed"].append(cur.cpu())
            cur = _greedy(model, logits, cfg.vocab)
            out["picks"].append(cur.cpu())
            out["logits"].append(logits.cpu())
    out["cache"] = cache
    return out


def _rank_serve(comm, device, *, cfg, params, tokens, lens, max_seq: int,
                steps: int, feed, seq_shard: bool, keep_cache: bool,
                embeds=None) -> dict:
    """One rank: its model, :func:`_serve_loop` on its rows, its logits
    blocks, picks, timings, collectives, bytes and peak."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    model = api.grid_model(cfg, params, comm, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    rows = (lambda t: rank_rows(t, comm).to(device))
    out = _serve_loop(model, cfg, rows(tokens), rows(lens), max_seq, steps,
                      None if feed is None else rows(feed.T).T, seq_shard,
                      device, comm, None if embeds is None else rows(embeds))
    cache = out.pop("cache")
    out.update({
        "cache_bytes": tree_bytes(cache),
        "cache_shapes": {k: tuple(v.shape)
                         for k, v in _first_layer(cache).items()},
        "param_bytes": _param_bytes(model),
        "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda
        else None,
        "cache": (tree_map(lambda t: t.cpu(), cache, is_leaf=torch.is_tensor)
                  if keep_cache else None)})
    del model, cache
    _release(device)
    return out


def grid_serve(world, grid, cfg, params: dict, tokens, lens, max_seq: int,
               steps: int, *, feed=None, seq_shard: bool = True,
               keep_cache: bool = False, embeds=None) -> dict:
    """Prefill of ``tokens`` (B, S; row b's first ``lens[b]`` real) and
    ``steps`` decode steps of ``cfg`` on ``grid`` (the first ranks of
    ``world``) from the whole parameter tree ``params``.  Returns the
    logits (steps + 1, B, Vpad) and greedy picks (steps, B) assembled over
    the grid (``models.sharding.assemble``: every model rank's picks the
    same bits), with ``keep_cache`` the cache after the last step
    assembled, and each rank's ``step_s``, ``prefill_s``, ``calls`` (the
    last step's ``Comm`` record a group), ``host_s``, ``prefill_calls``,
    ``param_bytes``, ``cache_bytes``, ``cache_shapes``, ``peak_bytes``.
    ``embeds``: the family's frontend embeddings (B, F, D), module
    docstring."""
    g = as_grid(grid)
    outs = world.run_grid(_rank_serve, g, cfg=cfg, params=params,
                          tokens=tokens, lens=lens, max_seq=max_seq,
                          steps=steps, feed=feed, seq_shard=seq_shard,
                          keep_cache=keep_cache, embeds=embeds)
    B = tokens.shape[0]
    rules = make_rules(g, fsdp=cfg.fsdp)
    lspec = rules.spec_for((B, cfg.padded_vocab), ("batch", "vocab"))
    bspec = rules.spec_for((B,), ("batch",))
    res = {"logits": torch.stack([
        assemble([o["logits"][t] for o in outs], lspec, g)
        for t in range(steps + 1)]),
        "picks": torch.stack([assemble([o["picks"][t] for o in outs],
                                       bspec, g) for t in range(steps)]),
        "cache": None}
    if keep_cache:
        res["cache"] = assemble_tree(
            [o["cache"] for o in outs],
            api.cache_shardings(cfg, B, max_seq, g, seq_shard, frames=(
                embeds.shape[1] if cfg.family == "audio" else None)), g)
    for k in ("step_s", "prefill_s", "calls", "host_s", "prefill_calls",
              "param_bytes", "cache_bytes", "cache_shapes", "peak_bytes"):
        res[k] = [o.get(k) for o in outs]
    return res


def one_process_serve(cfg, params: dict, tokens, lens, max_seq: int,
                      steps: int, *, feed=None, embeds=None) -> dict:
    """The same prefill and decode steps in this process on ``params``'
    device: ``logits`` (steps + 1, B, Vpad), ``picks``, ``fed`` (the
    tokens each step took), ``cache``, ``step_s``, ``prefill_s``."""
    model = api.build_model(cfg, params)
    dev = model.device
    out = _serve_loop(model, cfg, tokens.to(dev), lens.to(dev), max_seq,
                      steps, None if feed is None else feed.to(dev), True,
                      dev, embeds=None if embeds is None else embeds.to(dev))
    for k in ("logits", "picks", "fed"):
        out[k] = torch.stack(out[k])
    return out


# ------------------------------------------------------------- the engine --

def _rank_engine(comm, device, *, cfg, params, prompts, max_new: int,
                 serve, seq_shard: bool) -> dict:
    """One rank: the engine on the grid, every request's tokens (and its
    row's own, before :meth:`Engine.generate` joins the rows), the
    generate call's seconds, the rank's parameter and cache bytes and
    peak."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    model = api.grid_model(cfg, params, comm, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    eng = Engine(cfg, model, serve, grid=comm, seq_shard=seq_shard)
    sync_device(device)
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new)
    sync_device(device)
    rec = {"outs": outs, "generate_s": time.perf_counter() - t0,
           "row_outs": [eng.requests[r].out for r in sorted(eng.requests)],
           "param_bytes": _param_bytes(model),
           "cache_bytes": tree_bytes(eng.cache),
           "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda
           else None}
    del eng, model
    _release(device)
    return rec


def grid_engine(world, grid, cfg, params: dict, prompts, max_new: int,
                serve, *, seq_shard: bool = True) -> list:
    """``serve.Engine`` of ``cfg`` on ``grid`` generating ``max_new``
    tokens for every prompt: each rank's record (:func:`_rank_engine`; its
    ``outs`` every request's tokens)."""
    return world.run_grid(_rank_engine, as_grid(grid), cfg=cfg,
                          params=params, prompts=prompts, max_new=max_new,
                          serve=serve, seq_shard=seq_shard)


def _rank_oracle(comm, device, *, cfg, params, prompts, max_new: int,
                 serve, seq_shard: bool) -> dict:
    """One rank: the engine's stepwise greedy oracle on the grid -- the
    row's prompts (row, row + R, ...; at most its slots), each prefilled
    alone at its bucket into its slot, then ``max_new`` decode steps of
    all the row's slots (the last prompt token replayed first), as the
    engine calls them -- with each call timed.  The ssm family's prompts
    are prefilled unpadded and their first token is the prefill's, decode
    starting at the prompt's length (the engine's rule, ``RECURRENT``):
    ``max_new - 1`` decode steps follow.  ``calls``: the last decode
    call's collectives by group (the sampling's not counted)."""
    device = torch.device(device)
    model = api.grid_model(cfg, params, comm, device)
    batch = comm.batch
    row, rows = (0, 1) if batch is None else (batch.rank, batch.size)
    mine = list(range(row, len(prompts), rows))
    slots = serve.slots // rows
    if len(mine) > slots:
        raise ValueError(f"{len(mine)} prompts for {slots} slots a row")
    cache = api.init_cache(cfg, serve.slots, serve.max_seq, device,
                           grid=comm.grid, seq_shard=seq_shard)
    tok = torch.zeros((slots,), dtype=torch.int64, device=device)
    pos = torch.zeros((slots,), dtype=torch.int64, device=device)
    recurrent = cfg.family in RECURRENT
    prefill_s, step_s = [], []
    outs, finite = [[] for _ in mine], True
    with torch.no_grad():
        for s, i in enumerate(mine):
            p = prompts[i]
            bucket = len(p) if recurrent else bucket_pow2(
                len(p), serve.min_bucket, serve.max_seq)
            toks = torch.zeros((1, bucket), dtype=torch.int64, device=device)
            toks[0, :len(p)] = torch.tensor(p, device=device)
            sync_device(device)
            t0 = time.perf_counter()
            logits, one = api.prefill(model, cfg, {"tokens": toks},
                                      max_seq=serve.max_seq,
                                      seq_shard=seq_shard)
            for sub, leaves in one["blocks"].items():
                for name, leaf in leaves.items():
                    cache["blocks"][sub][name][:, s] = leaf[:, 0]
            if recurrent:
                tok[s], pos[s] = _greedy(model, logits, cfg.vocab)[0], len(p)
                outs[s].append(int(tok[s]))
            else:
                tok[s], pos[s] = p[-1], len(p) - 1
            sync_device(device)
            prefill_s.append(time.perf_counter() - t0)
        calls = None
        for _ in range(max_new - recurrent):
            comm.reset()
            sync_device(device)
            t0 = time.perf_counter()
            logits, cache = api.decode_step(model, cfg, cache, tok, pos,
                                            seq_shard=seq_shard)
            calls = comm.counters()
            tok = _greedy(model, logits, cfg.vocab)
            sync_device(device)
            step_s.append(time.perf_counter() - t0)
            finite = finite and bool(torch.isfinite(logits).all())
            for s in range(len(mine)):
                outs[s].append(int(tok[s]))
            pos = pos + 1
    del model, cache
    _release(device)
    return {"outs": dict(zip(mine, outs)), "prefill_s": prefill_s,
            "step_s": step_s, "finite": finite, "calls": calls}


def grid_oracle(world, grid, cfg, params: dict, prompts, max_new: int,
                serve, *, seq_shard: bool = True) -> dict:
    """The stepwise greedy oracle of :func:`grid_engine` on ``grid``:
    ``{"outs": every request's tokens, "prefill_s", "step_s", "calls"}``
    (each rank's lists; ``calls`` its last decode call's collectives) and
    ``finite`` (every step's logits on every rank); raises if a row's
    model ranks disagree."""
    recs = world.run_grid(_rank_oracle, as_grid(grid), cfg=cfg,
                          params=params, prompts=prompts, max_new=max_new,
                          serve=serve, seq_shard=seq_shard)
    outs: dict = {}
    for rec in recs:
        for i, toks in rec["outs"].items():
            if outs.setdefault(i, toks) != toks:
                raise RuntimeError(f"request {i}: the model ranks of its "
                                   "row drew different tokens")
    return {"outs": [outs[i] for i in range(len(prompts))],
            "prefill_s": [r["prefill_s"] for r in recs],
            "step_s": [r["step_s"] for r in recs],
            "calls": [r["calls"] for r in recs],
            "finite": all(r["finite"] for r in recs)}


# ------------------------------------------------------ sampling, refusals --

def _rank_sample(comm, device, *, cfg, logits, temperature: float) -> dict:
    """One rank: its vocab columns of whole ``logits``, the engine's
    tokens from them (``serve.engine.sample_tokens``, generator seed 1),
    ``GridLayout.greedy`` and ``whole_vocab``, and its 'model' group's
    record of the three calls."""
    lay = api.GridLayout(cfg, comm)
    spec = make_rules(comm.grid).spec_for(tuple(logits.shape),
                                          (None, "vocab"))
    block = cut(logits, spec, comm.grid, comm.coords)
    comm.reset()
    gen = torch.Generator(device=block.device).manual_seed(1)
    return {"greedy": lay.greedy(block, cfg.vocab),
            "sampled": sample_tokens(block, cfg.vocab, temperature, gen,
                                     lay),
            "whole": lay.whole_vocab(block),
            "calls": comm.counters()["model"]}


def sample_on_grid(world, grid, cfg, logits, temperature: float) -> list:
    """:func:`_rank_sample` on every rank of ``grid``."""
    return world.run_grid(_rank_sample, as_grid(grid), cfg=cfg,
                          logits=logits, temperature=temperature)


def _refused(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


def _rank_refusals(comm, device, *, params, archs) -> list:
    """One rank: the messages (or ``"no error"``) of serving each of
    ``archs``' reduced configs on the grid -- ``api.grid_model``, then
    ``prefill`` / ``decode_step`` of the dense rank's model (``params``:
    llama3.2-3b reduced's) under that config, ``Engine(..., grid=)`` --
    and of the engine given a whole model and an FSDP model."""
    from repro_torch.configs import get_reduced
    from repro_torch.serve import ServeConfig
    dense = get_reduced("llama3_2_3b")
    model = api.grid_model(dense, params, comm)
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int64)}
    out = []
    for arch in archs:
        cfg = get_reduced(arch)
        out += [_refused(lambda: api.grid_model(cfg, params, comm)),
                _refused(lambda: api.prefill(model, cfg, batch, max_seq=16)),
                _refused(lambda: api.decode_step(
                    model, cfg, {}, torch.zeros(1), torch.zeros(1))),
                _refused(lambda: Engine(cfg, model, ServeConfig(),
                                        grid=comm))]
    fsdp = dataclasses.replace(dense, fsdp=True)
    out += [_refused(lambda: Engine(dense, api.build_model(dense, params),
                                    ServeConfig(), grid=comm)),
            _refused(lambda: Engine(fsdp, api.grid_model(fsdp, params, comm),
                                    ServeConfig(), grid=comm))]
    return out


def refusals_on_grid(world, grid, params: dict, archs) -> list:
    """:func:`_rank_refusals` on every rank of ``grid``: each raises
    before any collective, so no rank waits on another."""
    return world.run_grid(_rank_refusals, as_grid(grid), params=params,
                          archs=archs)
