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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .module import ParamSpec

F32 = torch.float32


def moe_specs(cfg) -> dict:
    d, f, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    e = cfg.moe.num_experts
    return {
        "router": ParamSpec((d, e), ("embed", None), F32),
        "w1": ParamSpec((e, d, f), ("expert", "embed", "mlp"), pd),
        "w3": ParamSpec((e, d, f), ("expert", "embed", "mlp"), pd),
        "w2": ParamSpec((e, f, d), ("expert", "mlp", "embed"), pd),
    }


def _capacity(tokens: int, k: int, e: int, factor: float) -> int:
    cap = int(tokens * k / e * factor)
    return max(8, -(-cap // 8) * 8)  # pad to 8 for clean layouts


def moe_block(p, x: torch.Tensor, cfg) -> tuple[torch.Tensor, dict]:
    """x (B, S, D) -> (B, S, D), metrics.  Top-k routing, capacity C.

    With ``cfg.moe.groups > 1`` the dispatch (sort, ranking, capacity) runs
    independently per token group (the GShard convention; the reference
    maps it over groups), and the metrics are the groups' means."""
    B, S, D = x.shape
    T_all = B * S
    G = cfg.moe.groups
    if G > 1:
        if T_all % G:
            raise ValueError(f"tokens {T_all} not divisible by groups {G}")
        parts = [_moe_dispatch(p, xs, cfg)
                 for xs in x.reshape(G, T_all // G, D)]
        out = torch.stack([o for o, _ in parts]).reshape(B, S, D)
        return out, {k: torch.stack([m[k] for _, m in parts]).mean()
                     for k in parts[0][1]}
    out, metrics = _moe_dispatch(p, x.reshape(T_all, D), cfg)
    return out.reshape(B, S, D), metrics


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest in descending order, ties toward the
    lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _moe_dispatch(p, xf: torch.Tensor, cfg) -> tuple[torch.Tensor, dict]:
    """Sort-based top-k dispatch over a flat token group xf (T, D)."""
    mcfg = cfg.moe
    T, D = xf.shape
    E, K = mcfg.num_experts, mcfg.top_k
    C = _capacity(T, K, E, mcfg.capacity_factor)
    dev = xf.device

    logits = xf.to(F32) @ p["router"].to(F32)
    probs = torch.softmax(logits, dim=-1)
    gate, sel = _top_k(probs, K)                              # (T, K)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # ---- sort-based dispatch ------------------------------------------
    expert_flat = sel.reshape(T * K)
    token_flat = torch.arange(T, device=dev).repeat_interleave(K)
    gate_flat = gate.reshape(T * K)
    order = torch.argsort(expert_flat, stable=True)
    e_sorted = expert_flat[order]
    t_sorted = token_flat[order]
    g_sorted = gate_flat[order]
    counts = torch.bincount(expert_flat, minlength=E)         # tokens per expert
    starts = torch.cumsum(counts, 0) - counts                 # exclusive prefix
    pos_in_expert = torch.arange(T * K, device=dev) - starts[e_sorted]
    keep = pos_in_expert < C
    dest = torch.where(keep, e_sorted * C + pos_in_expert, E * C)

    # gather tokens into (E*C, D) buffers; row E*C takes the dropped ones
    buf = torch.zeros((E * C + 1, D), dtype=xf.dtype, device=dev)
    buf[dest] = xf[t_sorted]
    buf = buf[:E * C].reshape(E, C, D)

    # ---- expert computation --------------------------------------------
    h = F.silu(torch.bmm(buf, p["w1"]))
    g = torch.bmm(buf, p["w3"])
    out_buf = torch.bmm(h * g, p["w2"]).reshape(E * C, D)

    # ---- combine: each token's slots in ascending expert order ----------
    slot_out = torch.where(keep[:, None],
                           out_buf[torch.clamp_max(dest, E * C - 1)],
                           torch.zeros((), dtype=out_buf.dtype, device=dev))
    contrib = slot_out.to(F32) * g_sorted[:, None]           # sorted order
    rank = torch.empty_like(order)
    rank[order] = torch.arange(T * K, device=dev)            # flat -> sorted
    by_expert = torch.argsort(sel, dim=-1)                   # distinct experts
    slots = rank.reshape(T, K).gather(1, by_expert)          # (T, K)
    out = torch.zeros((T, D), dtype=F32, device=dev)
    for j in range(K):
        out = out + contrib[slots[:, j]]

    # ---- aux losses / metrics ------------------------------------------
    me = probs.mean(dim=0)                                   # mean router prob
    ce = torch.bincount(sel.reshape(-1), minlength=E).to(F32) / (T * K)
    aux = E * torch.sum(me * ce) * mcfg.aux_loss_weight      # Switch LB loss
    drop_frac = 1.0 - keep.sum().to(F32) / (T * K)
    return out.to(xf.dtype), {"moe_aux_loss": aux, "moe_drop_frac": drop_frac}
