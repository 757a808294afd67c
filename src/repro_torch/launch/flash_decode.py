"""Flash-decoding over a sequence-sharded cache on a world of ranks: the
twin of the reference's flash-decoding check (``decode_attention_seqsharded``
against the dense ``decode_attention``, with the reduction's bytes below a
quarter of the cache's), and greedy decode steps of a model on the shards
against the local ``decode_step`` on the whole cache.

The ranks are a :class:`~repro_torch.core.world.SolverWorld` (gloo ranks
share the card or the CPU).  Operands reach them as the world passes any
argument: CUDA tensors by IPC (no copy), CPU tensors through shared
memory; each rank cuts its own shard.

Run:  PYTHONPATH=src python -m repro_torch.launch.flash_decode
      [--ranks P] [--device cuda|cpu] [--seed N]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.world import sync_device
from repro_torch.data.regression import check_device
from repro_torch.models import api
from repro_torch.models import layers as L


def _release(device) -> None:
    """Give a rank's cached blocks back to the card it shares."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def release_rank(comm, device) -> None:
    """:func:`_release` as a rank function (``SolverWorld.run``)."""
    _release(device)


def _flash_rank(comm, device, *, q, cache_k, cache_v, pos) -> dict:
    """One rank: its shard of the cache, one flash-decoding call."""
    S_local = cache_k.shape[1] // comm.size
    lo = comm.rank * S_local
    ck = cache_k[:, lo:lo + S_local].to(device)
    cv = cache_v[:, lo:lo + S_local].to(device)
    comm.reset()
    out = L.decode_attention_seqsharded(q.to(device), ck, cv,
                                        pos.to(device), comm=comm)
    sync_device(device)
    rec = {"out": out.cpu(), "counters": comm.counters()}
    del ck, cv, out
    _release(device)
    return rec


def flash_decode(world, q, cache_k, cache_v, pos, n_ranks: int) -> dict:
    """``decode_attention_seqsharded`` on the first ``n_ranks`` ranks of
    ``world``, the cache (B, S, Hkv, Dh) cut into ``n_ranks`` sequence
    shards.  Returns rank 0's output (every rank's must be the same bytes)
    and each rank's ``Comm`` record."""
    outs = world.run(_flash_rank, n_ranks, q=q, cache_k=cache_k,
                     cache_v=cache_v, pos=pos)
    first = outs[0]["out"]
    if not all(torch.equal(o["out"], first) for o in outs[1:]):
        raise RuntimeError("flash-decoding gave different outputs on the "
                           "ranks")
    return {"out": first, "counters": [o["counters"] for o in outs]}


def _greedy(model, cfg, cache, token, pos, steps: int, comm=None,
            feed=None, expert_comm=None) -> dict:
    """``steps`` decode steps from (token, pos), each fed the argmax of the
    last logits (or ``feed[:, i]`` while there is one); ``comm`` shards the
    cache's sequence, ``expert_comm`` an MoE model's experts
    (``api.decode_step``).  Per step the logits, the tokens, the
    all-reduces (``comm``'s), the all-gathers (``expert_comm``'s) and the
    seconds (host clock to a synchronize)."""
    device = model.device
    token, pos = token.to(device), pos.to(device)
    logits_all, tokens, reduces, gathers, secs = [], [], [], [], []
    with torch.no_grad():
        for i in range(steps):
            for c in (comm, expert_comm):
                if c is not None:
                    c.reset()
            sync_device(device)
            t0 = time.perf_counter()
            logits, cache = api.decode_step(model, cfg, cache, token, pos,
                                            comm=comm,
                                            expert_comm=expert_comm)
            sync_device(device)
            secs.append(time.perf_counter() - t0)
            reduces.append(0 if comm is None else comm.all_reduces)
            gathers.append(0 if expert_comm is None
                           else expert_comm.all_gathers)
            token = (feed[:, i].to(device)
                     if feed is not None and i < feed.shape[1]
                     else logits[:, :cfg.vocab].argmax(-1))
            pos = pos + 1
            logits_all.append(logits.float().cpu())
            tokens.append(token.cpu())
    return {"logits": torch.stack(logits_all), "tokens": torch.stack(tokens),
            "all_reduces": reduces, "all_gathers": gathers, "step_s": secs}


def _decode_rank(comm, device, *, cfg, params, cache, token, pos,
                 steps: int) -> dict:
    """One rank: the model on ``params``, its shard of ``cache``, greedy
    steps on the shards; returns the shard after them (on the CPU)."""
    model = api.build_model(cfg, params)
    local = api.shard_cache(cache, cfg, comm.rank, comm.size)
    out = _greedy(model, cfg, local, token, pos, steps, comm)
    out["cache"] = {g: {k: (v.cpu() if torch.is_tensor(v) else
                            {n: t.cpu() for n, t in v.items()})
                        for k, v in tree.items()}
                    for g, tree in local.items()}
    del model, local
    _release(device)
    return out


def sharded_decode(world, cfg, params, cache, token, pos, steps: int,
                   n_ranks: int) -> dict:
    """``steps`` greedy ``decode_step`` calls of the model on ``params``
    with ``cache`` sequence-sharded over the first ``n_ranks`` ranks of
    ``world``, from (token, pos).  Returns rank 0's logits, tokens and
    all-reduces a step (every rank's tokens must agree), the slowest
    rank's seconds a step, and every rank's shard of the cache after the
    steps (``caches``, on the CPU)."""
    outs = world.run(_decode_rank, n_ranks, cfg=cfg, params=params,
                     cache=cache, token=token, pos=pos, steps=steps)
    first = outs[0]
    if not all(torch.equal(o["tokens"], first["tokens"]) for o in outs[1:]):
        raise RuntimeError("the ranks decoded different tokens")
    out = {k: first[k] for k in ("logits", "tokens", "all_reduces")}
    out["step_s"] = [max(o["step_s"][i] for o in outs) for i in range(steps)]
    out["caches"] = [o["cache"] for o in outs]
    return out


def local_decode(model, cfg, cache, token, pos, steps: int) -> dict:
    """The same greedy steps on the whole cache in this process."""
    return _greedy(model, cfg, cache, token, pos, steps)


def main(n_ranks: int = 4, device="cuda", seed: int = 0) -> float:
    """The reference check's shapes (B = 2, S = 64, H = 8, Hkv = 4, Dh =
    16, pos = [37, 11]) in f32: flash-decoding on the ranks against the
    dense decode attention; returns the largest difference."""
    from repro_torch.core import SolverWorld
    device = check_device(device)
    B, S, H, Hkv, Dh = 2, 64, 8, 4, 16
    gen = torch.Generator().manual_seed(seed)
    q, ck, cv = (torch.randn(shape, generator=gen).to(device)
                 for shape in ((B, 1, H, Dh), (B, S, Hkv, Dh),
                               (B, S, Hkv, Dh)))
    pos = torch.tensor([37, 11], device=device)
    dense = L.decode_attention(q, ck, cv, pos).cpu()
    with SolverWorld(n_ranks, device=device, kernels=False) as world:
        got = flash_decode(world, q, ck, cv, pos, n_ranks)
    err = float((got["out"] - dense).abs().max())
    c = got["counters"][0]
    cache_bytes = 2 * ck.numel() * ck.element_size()
    print(f"flash-decoding on {n_ranks} ranks ({device}): max |out - dense| "
          f"{err:.2e}; {c['all_reduces']} all-reduces ({c['max_reduces']} "
          f"max), {c['bytes']} bytes moved against a {cache_bytes}-byte "
          "cache")
    if not (err < 1e-5 and c["all_reduces"] == 2
            and c["bytes"] < cache_bytes / 4):
        raise RuntimeError("flash-decoding disagrees with the dense decode "
                           "attention or moved more than a quarter of the "
                           "cache")
    return err


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises without a card")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    main(args.ranks, args.device, args.seed)
