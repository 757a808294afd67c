"""Mixture-of-Experts block, the twin of ``repro.models.moe``: top-k routing
with sort-based capacity dispatch.

Tokens are sorted by expert id (a stable sort) and ranked within their
expert; each expert takes at most C = ceil8(tokens * k / E * capacity
factor) of them into an (E, C, D) buffer, every expert runs on its whole
buffer, and the outputs are combined with the renormalised top-k gates.
Overflowed tokens are dropped (combine weight 0; the residual carries
them), and the drop fraction is returned as a metric, with the Switch
load-balancing aux loss.

Plain torch, as the reference is plain jnp.  Where the reference leans on
a jnp behaviour, the port writes it out:
* ``lax.top_k`` breaks ties toward the lower index: a stable descending
  sort does the same (``torch.topk`` promises no order among ties);
* ``.at[dest].set(..., mode="drop")`` with the drop slot ``E * C``: the
  buffer has one row more, which is cut off;
* ``.at[t_sorted].add``: each token's kept slots are added in the order of
  the sorted scatter, ascending expert, one add at a time from +0, so the
  output is the same on every run and every device (``index_add_`` uses
  atomics on CUDA);
* the router runs in f32 (its weight is an f32 parameter in every model).

**Experts sharded over ranks** (``comm``: this rank's handle on a world of
P ranks, ``core.engine.Comm``).  The reference puts the expert axis on its
'model' mesh axis and lets GSPMD turn the dispatch and the combine into
all-to-alls; the port holds experts ``[r E / P, (r + 1) E / P)`` on rank r
(``E % P == 0``, else ``ValueError``: no expert is replicated) and places
the collectives itself, keeping the math of ONE global dispatch:

* ``replicated=False`` (training, a data-parallel prefill): the rank holds
  its rows of the global batch, rank-major, so its tokens are contiguous
  in the global flat order.  It routes them (the replicated f32 router),
  gathers every rank's (groups, E) counts with one all-gather, and ranks
  each slot globally: the counts of its expert on lower ranks plus its
  local position, against the capacity of the global token count.  One
  all-to-all sends the kept slots to their expert's owner, which runs its
  (E / P, C, D) buffers; a second brings the outputs back in the order
  they went, so the combine is the single dispatch's (ascending expert,
  one add at a time).  The aux loss takes ``me`` from one all-reduce of
  the router probabilities' (groups, E) sums and ``ce`` and the drop
  fraction from the gathered counts (``sum_e min(count_e, C)`` is the kept
  count): the metrics are the global batch's on every rank.  The
  collectives that carry a gradient are autograd functions: the
  all-to-all's backward is the reverse all-to-all, the probability sum's
  an all-reduce of the incoming gradient, so a loss that adds the aux
  loss once over the world (``aux / P`` on every rank) gets the global
  gradient.
* ``replicated=True`` (serving: every rank holds the same tokens): the
  single-rank dispatch, in which every rank routes all tokens, fills and
  runs its own experts only, and one all-gather of their (E / P * C, D)
  outputs a group lets every rank combine the same bytes.  No gradient
  flows back through that all-gather, so a graph that would need one
  raises.

``cfg.moe.groups > 1`` keeps its meaning: the groups follow the global
rows (a rank holds ``groups / P`` whole groups, or a group spans ``P /
groups`` ranks; other splits raise).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .module import ParamSpec

F32 = torch.float32
EXPERT_LEAVES = ("w1", "w2", "w3")      # the leaves cut on the expert axis


def check_expert_shards(num_experts: int, n_ranks: int) -> int:
    """Experts a rank holds: ``num_experts / n_ranks``; raises where they
    do not split evenly (experts are sharded, never replicated)."""
    if n_ranks < 1 or num_experts % n_ranks:
        raise ValueError(
            f"E={num_experts} experts do not split over P={n_ranks} ranks: "
            "experts are sharded over the ranks (E % P must be 0), none is "
            "replicated")
    return num_experts // n_ranks


def expert_range(num_experts: int, rank: int, n_ranks: int) -> tuple:
    """[lo, hi): the experts rank ``rank`` of ``n_ranks`` holds."""
    per = check_expert_shards(num_experts, n_ranks)
    return rank * per, (rank + 1) * per


def is_expert_path(path: tuple) -> bool:
    """Is the leaf at ``path`` (keys from the root of a parameter, gradient
    or optimizer tree) an expert weight, cut on the expert axis?"""
    return len(path) >= 2 and path[-2] == "moe" and \
        path[-1] in EXPERT_LEAVES


def map_experts(fn, tree, path=()):
    """``tree`` with ``fn(leaf)`` in place of every expert leaf (axis 0 the
    layer stack, axis 1 the experts), the other leaves as they are."""
    if isinstance(tree, dict):
        return {k: map_experts(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(tree) if is_expert_path(path) else tree


def cut_experts(tree, rank: int, n_ranks: int):
    """Rank ``rank``'s shard of a whole tree (parameters, gradients, a
    train state; tensors or numpy arrays): each expert leaf cut to the
    rank's experts on its expert axis (views), the rest as it is."""
    def cut(t):
        lo, hi = expert_range(t.shape[1], rank, n_ranks)
        return t[:, lo:hi]
    return map_experts(cut, tree)


def expert_mask(tree, path=()) -> list:
    """For each leaf of ``tree`` in sorted-key order: is it an expert
    leaf?"""
    if isinstance(tree, dict):
        return [m for k in sorted(tree)
                for m in expert_mask(tree[k], path + (k,))]
    return [is_expert_path(path)]


def gather_experts(tree, comm):
    """The whole tree on rank 0's host from each rank's shard (every rank
    must call it): each expert leaf joined one layer at a time, by an
    all-to-all that sends every rank's experts of that layer to rank 0
    (leaves in sorted-key order on every rank), so no rank's device holds
    more than one layer of one leaf beyond its shard.  Rank 0 gets every
    leaf as a CPU tensor, the other ranks ``None``."""
    lead = comm.rank == 0

    def walk(t, path):
        if isinstance(t, dict):
            out = {k: walk(t[k], path + (k,)) for k in sorted(t)}
            return out if lead else None
        if not is_expert_path(path):
            return t.detach().cpu() if lead else None
        n = t.shape[1]
        send = [n] + [0] * (comm.size - 1)
        recv = [n if lead else 0] * comm.size
        layers = [comm.all_to_all(t[i].detach().contiguous(), send, recv)
                  for i in range(t.shape[0])]
        return torch.stack([x.cpu() for x in layers]) if lead else None
    return walk(tree, ())


def moe_specs(cfg, n_ranks: int = 1) -> dict:
    """The block's specs; with ``n_ranks`` a rank's shard (E / P experts)."""
    d, f, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    e = check_expert_shards(cfg.moe.num_experts, n_ranks)
    return {
        "router": ParamSpec((d, cfg.moe.num_experts), ("embed", None), F32),
        "w1": ParamSpec((e, d, f), ("expert", "embed", "mlp"), pd),
        "w3": ParamSpec((e, d, f), ("expert", "embed", "mlp"), pd),
        "w2": ParamSpec((e, f, d), ("expert", "mlp", "embed"), pd),
    }


def _capacity(tokens: int, k: int, e: int, factor: float) -> int:
    cap = int(tokens * k / e * factor)
    return max(8, -(-cap // 8) * 8)  # pad to 8 for clean layouts


def moe_block(p, x: torch.Tensor, cfg, comm=None, replicated: bool = False
              ) -> tuple[torch.Tensor, dict]:
    """x (B, S, D) -> (B, S, D), metrics.  Top-k routing, capacity C.

    With ``cfg.moe.groups > 1`` the dispatch (sort, ranking, capacity) runs
    independently per token group (the GShard convention; the reference
    maps it over groups), and the metrics are the groups' means.  With
    ``comm`` of P > 1 ranks, ``p`` holds this rank's E / P experts and the
    dispatch is the world's (module docstring): x is this rank's rows of
    the global batch, or with ``replicated`` the same tokens on every
    rank."""
    B, S, D = x.shape
    E = cfg.moe.num_experts
    P = 1 if comm is None else comm.size
    held = p["w1"].shape[0]
    if held != check_expert_shards(E, P):
        raise ValueError(
            f"the block holds {held} of E={E} experts, but P={P} rank(s) "
            f"hold {E // P} each" + ("; pass the rank's comm" if comm is None
                                     else ""))
    T_all = B * S
    if P > 1 and not replicated:
        out, metrics = _sharded(p, x.reshape(T_all, D), cfg, comm)
        return out.reshape(B, S, D), metrics
    G = cfg.moe.groups
    if T_all % G:
        raise ValueError(f"tokens {T_all} not divisible by groups {G}")
    parts = [_dispatch(p, xs, cfg, comm if P > 1 else None)
             for xs in x.reshape(G, T_all // G, D)]
    out = torch.cat([o for o, _ in parts]).reshape(B, S, D)
    if G == 1:
        return out, parts[0][1]
    return out, {k: torch.stack([m[k] for _, m in parts]).mean()
                 for k in parts[0][1]}


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest in descending order, ties toward the
    lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _route(p, xf: torch.Tensor, cfg) -> dict:
    """Routing and the sorted slots of one token group xf (T, D): probs,
    the selection, and the stable sort by expert with each slot's position
    in its expert."""
    T = xf.shape[0]
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    dev = xf.device
    logits = xf.to(F32) @ p["router"].to(F32)
    probs = torch.softmax(logits, dim=-1)
    gate, sel = _top_k(probs, K)                              # (T, K)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    expert_flat = sel.reshape(T * K)
    token_flat = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(expert_flat, stable=True)
    e_sorted = expert_flat[order]
    counts = torch.bincount(expert_flat, minlength=E)     # tokens per expert
    starts = torch.cumsum(counts, 0) - counts             # exclusive prefix
    return {"probs": probs, "sel": sel, "order": order, "e_sorted": e_sorted,
            "t_sorted": token_flat[order],
            "g_sorted": gate.reshape(T * K)[order], "counts": counts,
            "pos": torch.arange(T * K, device=dev) - starts[e_sorted]}


def _experts(p, buf: torch.Tensor) -> torch.Tensor:
    """The experts on their buffers (e, C, D) -> (e * C, D)."""
    h = F.silu(torch.bmm(buf, p["w1"]))
    g = torch.bmm(buf, p["w3"])
    return torch.bmm(h * g, p["w2"]).reshape(-1, buf.shape[-1])


def _combine(r: dict, slot_out: torch.Tensor, K: int) -> torch.Tensor:
    """Each token's slots (``slot_out``: sorted order, zero where dropped)
    weighted by their gates and added in ascending expert order."""
    T = r["sel"].shape[0]
    dev = slot_out.device
    contrib = slot_out.to(F32) * r["g_sorted"][:, None]      # sorted order
    rank = torch.empty_like(r["order"])
    rank[r["order"]] = torch.arange(T * K, device=dev)       # flat -> sorted
    by_expert = torch.argsort(r["sel"], dim=-1)              # distinct experts
    slots = rank.reshape(T, K).gather(1, by_expert)          # (T, K)
    out = torch.zeros((T, slot_out.shape[1]), dtype=F32, device=dev)
    for j in range(K):
        out = out + contrib[slots[:, j]]
    return out


def _dispatch(p, xf: torch.Tensor, cfg, comm=None
              ) -> tuple[torch.Tensor, dict]:
    """Sort-based top-k dispatch over a flat token group xf (T, D).  With
    ``comm`` every rank holds the same tokens: it fills and runs only its
    own experts, and one all-gather of their (E / P * C, D) outputs lets
    every rank combine the same bytes."""
    mcfg = cfg.moe
    T, D = xf.shape
    E, K = mcfg.num_experts, mcfg.top_k
    El = p["w1"].shape[0]
    lo = 0 if comm is None else comm.rank * El
    C = _capacity(T, K, E, mcfg.capacity_factor)
    dev = xf.device
    r = _route(p, xf, cfg)
    keep = r["pos"] < C
    dest = torch.where(keep, r["e_sorted"] * C + r["pos"], E * C)
    mine = keep & (r["e_sorted"] >= lo) & (r["e_sorted"] < lo + El)

    # gather this rank's tokens into (El*C, D) buffers; row El*C takes the
    # dropped ones and those of other ranks' experts
    buf = torch.zeros((El * C + 1, D), dtype=xf.dtype, device=dev)
    buf[torch.where(mine, dest - lo * C, El * C)] = xf[r["t_sorted"]]
    out_buf = _experts(p, buf[:El * C].reshape(El, C, D))
    if comm is not None:
        if torch.is_grad_enabled() and out_buf.requires_grad:
            raise RuntimeError("replicated tokens are for serving: no "
                               "gradient flows through the experts' "
                               "all-gather")
        out_buf = comm.all_gather(out_buf).reshape(E * C, D)

    slot_out = torch.where(keep[:, None],
                           out_buf[torch.clamp_max(dest, E * C - 1)],
                           torch.zeros((), dtype=out_buf.dtype, device=dev))
    out = _combine(r, slot_out, K)
    return out.to(xf.dtype), _metrics(r["probs"].mean(dim=0), r["sel"],
                                      keep.sum(), T, cfg)


def _metrics(me, sel, kept, T: int, cfg) -> dict:
    """The Switch aux loss from the mean router probability ``me`` and the
    selection's counts, and the drop fraction from the kept count."""
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    ce = torch.bincount(sel.reshape(-1), minlength=E).to(F32) / (T * K)
    aux = E * torch.sum(me * ce) * cfg.moe.aux_loss_weight   # Switch LB loss
    drop_frac = 1.0 - kept.to(F32) / (T * K)
    return {"moe_aux_loss": aux, "moe_drop_frac": drop_frac}


# ---------------------------------------------------------------------------
# Experts sharded over ranks
# ---------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    """Rows to their ranks; the backward sends the gradients back."""

    @staticmethod
    def forward(ctx, send, comm, send_counts, recv_counts):
        ctx.comm, ctx.counts = comm, (send_counts, recv_counts)
        return comm.all_to_all(send, send_counts, recv_counts)

    @staticmethod
    def backward(ctx, grad):
        send_counts, recv_counts = ctx.counts
        return (ctx.comm.all_to_all(grad.contiguous(), recv_counts,
                                    send_counts), None, None, None)


class _AllReduce(torch.autograd.Function):
    """A sum over the ranks; the backward sums the incoming gradients."""

    @staticmethod
    def forward(ctx, t, comm):
        ctx.comm = comm
        return comm.all_reduce(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.all_reduce(grad.clone()), None


def _segments(T_local: int, cfg, comm) -> tuple:
    """(segments on this rank, tokens a group, the group of the first):
    the groups follow the global rows, rank-major."""
    G, P = cfg.moe.groups, comm.size
    T_all = T_local * P
    if T_all % G:
        raise ValueError(f"tokens {T_all} not divisible by groups {G}")
    if G % P == 0:
        return G // P, T_all // G, comm.rank * (G // P)
    if P % G == 0:
        return 1, T_all // G, comm.rank // (P // G)
    raise ValueError(f"groups={G} must divide or be a multiple of the "
                     f"P={P} ranks the tokens are sharded over")


def _sharded(p, xl: torch.Tensor, cfg, comm) -> tuple[torch.Tensor, dict]:
    """One global dispatch over every rank's rows (module docstring); xl
    (T_local, D) is this rank's."""
    mcfg = cfg.moe
    T_loc, D = xl.shape
    E, K, G, P = mcfg.num_experts, mcfg.top_k, mcfg.groups, comm.size
    El = E // P
    lo = comm.rank * El
    n_seg, Tg, g0 = _segments(T_loc, cfg, comm)
    Ts = T_loc // n_seg
    C = _capacity(Tg, K, E, mcfg.capacity_factor)
    dev = xl.device
    routes = [_route(p, xs, cfg) for xs in xl.reshape(n_seg, Ts, D)]
    gids = torch.arange(g0, g0 + n_seg, device=dev)

    # every rank's (groups, E) counts, and the global probability sums
    counts = torch.zeros((G, E), dtype=torch.int64, device=dev)
    counts[gids] = torch.stack([r["counts"] for r in routes])
    all_counts = comm.all_gather(counts)                          # (P, G, E)
    psum = torch.zeros((G, E), dtype=F32, device=dev).index_add(
        0, gids, torch.stack([r["probs"].sum(dim=0) for r in routes]))
    psum = _AllReduce.apply(psum, comm)
    off = torch.cumsum(all_counts, 0) - all_counts               # lower ranks
    kept = torch.minimum(all_counts, (C - off).clamp_min(0))     # (P, G, E)
    host = kept.cpu()               # the split sizes: one wait on the device
    send_counts = host[comm.rank].reshape(G, P, El).sum((0, 2)).tolist()
    recv_counts = host[:, :, lo:lo + El].sum((1, 2)).tolist()

    # each kept slot's owner and row in the owner's (G, El, C) buffers
    keys, src, at = [], [], []
    for s, r in enumerate(routes):
        g = g0 + s
        pos = off[comm.rank, g][r["e_sorted"]] + r["pos"]
        keep = pos < C
        owner = r["e_sorted"] // El
        row = (g * El + r["e_sorted"] % El) * C + pos
        keys.append((owner * (G * El * C) + row)[keep])
        src.append((s * Ts + r["t_sorted"])[keep])
        at.append(torch.nonzero(keep)[:, 0] + s * Ts * K)
    keys, src, at = torch.cat(keys), torch.cat(src), torch.cat(at)
    sent = torch.argsort(keys)
    recv = _AllToAll.apply(xl[src[sent]], comm, send_counts, recv_counts)

    # the rows received, from rank r's kept slots of (group, expert) in order
    lens = kept[:, :, lo:lo + El].reshape(-1)
    base = ((torch.arange(G, device=dev)[:, None] * El
             + torch.arange(El, device=dev)) * C)[None] + off[:, :, lo:lo + El]
    total = sum(recv_counts)
    first = torch.cumsum(lens, 0) - lens
    rows = (torch.repeat_interleave(base.reshape(-1), lens,
                                    output_size=total)
            + torch.arange(total, device=dev)
            - torch.repeat_interleave(first, lens, output_size=total))
    buf = torch.zeros((G * El * C, D), dtype=xl.dtype, device=dev
                      ).index_copy(0, rows, recv).reshape(G, El, C, D)
    out_buf = torch.cat([_experts(p, buf[g]) for g in range(G)])
    back = _AllToAll.apply(out_buf[rows], comm, recv_counts, send_counts)
    slot_out = torch.zeros((n_seg * Ts * K, D), dtype=out_buf.dtype,
                           device=dev).index_copy(0, at[sent], back)
    out = torch.cat([_combine(r, so, K) for r, so in zip(
        routes, slot_out.reshape(n_seg, Ts * K, D))])

    # the global batch's metrics, the groups' means
    tot = all_counts.sum(0).to(F32)                               # (G, E)
    me = psum / Tg
    aux = E * torch.sum(me * (tot / (Tg * K)), dim=-1) * mcfg.aux_loss_weight
    drop = 1.0 - torch.minimum(tot, torch.full_like(tot, C)).sum(-1) / (
        Tg * K)
    metrics = ({"moe_aux_loss": aux[0], "moe_drop_frac": drop[0]} if G == 1
               else {"moe_aux_loss": aux.mean(), "moe_drop_frac": drop.mean()})
    return out.to(xl.dtype), metrics
