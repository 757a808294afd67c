"""Transformer building blocks, the twin of ``repro.models.layers``: norms,
RoPE, chunked flash-style attention (GQA), the decode attention against a
cache, the SwiGLU MLP and the embeddings, as functions over mappings of
parameter tensors (a ``dict`` or an ``nn.ParameterDict``).

The reference writes these in plain jnp, with no Pallas kernel, and so does
the port in plain torch, block for block.  Where the reference asks an
einsum for f32 results of low-precision inputs (``preferred_element_type``),
the port upcasts the inputs and multiplies in f32: a product of two bf16
values is exact in f32, so only the order of the f32 sums differs.  The
same holds for the norms, rope and the softmax statistics, which the
reference keeps in f32: the port computes them in the wider of f32 and the
input's type (:func:`acc_dtype`), so an f64 model runs in f64 throughout
and bf16 / f32 models are unchanged.
Layouts are the reference's: q (B, S, H, Dh), k / v (B, S, Hkv, Dh), and a
query head h = hkv * G + g of the Hkv * G heads.

``decode_attention_seqsharded`` (flash-decoding over a sequence-sharded
cache) runs on a world of ranks: the reference's ``shard_map`` body with
its ``pmax`` / ``psum`` becomes the rank's own shard and two all-reduces
of its :class:`~repro_torch.core.engine.Comm`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .module import ParamSpec

NEG_INF = -2.0 ** 30  # finite mask value: keeps fully-masked rows NaN-free


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type of a layer's inner arithmetic: f32, or f64 for f64 inputs."""
    return torch.promote_types(dtype, torch.float32)


# ---------------------------------------------------------------- norms ----

def rmsnorm_spec(d: int, dtype) -> ParamSpec:
    return ParamSpec((d,), ("embed",), dtype, init="ones")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    acc = acc_dtype(x.dtype)
    xa = x.to(acc)
    y = xa * torch.rsqrt(torch.mean(xa * xa, dim=-1, keepdim=True) + eps)
    return (y * w.to(acc)).to(x.dtype)


# ----------------------------------------------------------------- rope ----

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding, half-rotation convention.  x (..., S, H, Dh),
    positions (..., S) integer absolute positions."""
    dh = x.shape[-1]
    half = dh // 2
    acc = acc_dtype(x.dtype)
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=acc, device=x.device) / half)
    ang = positions.to(acc)[..., None] * freqs              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(acc), x[..., half:].to(acc)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ----

def attention_specs(cfg, *, cross: bool = False) -> dict:
    d, h, hkv, dh = (cfg.d_model, cfg.resolved_q_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    pd = cfg.param_dtype
    specs = {
        "wq": ParamSpec((d, h, dh), ("embed", "heads", "head_dim"), pd),
        "wk": ParamSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim"), pd),
        "wv": ParamSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim"), pd),
        "wo": ParamSpec((h, dh, d), ("heads", "head_dim", "embed"), pd),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h, dh), ("heads", "head_dim"), pd, init="zeros")
        specs["bk"] = ParamSpec((hkv, dh), ("kv_heads", "head_dim"), pd,
                                init="zeros")
        specs["bv"] = ParamSpec((hkv, dh), ("kv_heads", "head_dim"), pd,
                                init="zeros")
    return specs


def qkv_proj(p, x: torch.Tensor, x_kv: torch.Tensor | None = None):
    """x (B, S, D) -> q (B, S, H, Dh), k / v (B, Skv, Hkv, Dh)."""
    x_kv = x if x_kv is None else x_kv
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x_kv, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x_kv, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def out_proj(p, attn_out: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", attn_out, p["wo"])


def _acc_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(..., preferred_element_type=f32)``: exact products, f32
    sums (f64 for f64 inputs)."""
    acc = acc_dtype(a.dtype)
    return torch.einsum(eq, a.to(acc), b.to(acc))


def _gqa_scores(qb, kb, scale):
    # qb (B, bq, Hkv, G, Dh), kb (B, bkv, Hkv, Dh) -> (B, Hkv, G, bq, bkv)
    return _acc_einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_offset: int = 0, causal: bool = True,
                      block_q: int = 512, block_kv: int = 1024
                      ) -> torch.Tensor:
    """Online-softmax attention.  q (B, Sq, H, Dh); k, v (B, Skv, Hkv, Dh).
    Query position i attends to key positions <= q_offset + i when causal.
    Returns (B, Sq, H, Dh).

    The reference's blocks, in its order: queries in blocks of ``block_q``,
    and for each a running (max, sum, accumulator) over key blocks of
    ``block_kv``; ragged lengths are padded to whole blocks (padded keys
    masked, padded query rows dropped).  A causal key block that lies wholly
    after a query block's last position is skipped: every score in it is
    masked, and after the first key block (which every query sees) such a
    block leaves the running max, sum and accumulator exactly as they are
    (its weights are exp(NEG_INF - m) = 0 and its correction exp(0) = 1)."""
    B, Sq, H, Dh = q.shape
    Skv_real, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(Dh)
    bq = min(block_q, Sq)
    bkv = min(block_kv, Skv_real)
    q_pad = (-Sq) % bq
    kv_pad = (-Skv_real) % bkv
    if q_pad:
        q = F.pad(q, (0, 0, 0, 0, 0, q_pad))
    if kv_pad:
        k = F.pad(k, (0, 0, 0, 0, 0, kv_pad))
        v = F.pad(v, (0, 0, 0, 0, 0, kv_pad))
    nq, nkv = (Sq + q_pad) // bq, (Skv_real + kv_pad) // bkv
    qr = q.reshape(B, nq, bq, Hkv, G, Dh)
    kr = k.reshape(B, nkv, bkv, Hkv, Dh)
    vr = v.reshape(B, nkv, bkv, Hkv, Dh)
    dev, acc_t = q.device, acc_dtype(q.dtype)
    ar_q = torch.arange(bq, device=dev)
    ar_kv = torch.arange(bkv, device=dev)

    outs = []
    for iq in range(nq):
        qb = qr[:, iq]
        qpos = q_offset + iq * bq + ar_q
        last = q_offset + iq * bq + bq - 1
        m = torch.full((B, Hkv, G, bq), NEG_INF, dtype=acc_t, device=dev)
        lsum = torch.zeros((B, Hkv, G, bq), dtype=acc_t, device=dev)
        acc = torch.zeros((B, Hkv, G, bq, Dh), dtype=acc_t, device=dev)
        for ikv in range(nkv):
            if causal and ikv > 0 and ikv * bkv > last:
                break
            s = _gqa_scores(qb, kr[:, ikv], scale)           # (B,Hkv,G,bq,bkv)
            kpos = ikv * bkv + ar_kv
            mask = (kpos < Skv_real)[None, :]                # exclude kv padding
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])  # (bq, bkv)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + p.sum(dim=-1)
            pv = _acc_einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype), vr[:, ikv])
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp_min(lsum[..., None], 1e-30))
    out = torch.stack(outs, dim=1)                      # (B, nq, Hkv, G, bq, Dh)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, Sq + q_pad, H, Dh)
    return out[:, :Sq].to(q.dtype)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos) -> torch.Tensor:
    """Single-step attention against a cache.  q (B, 1, H, Dh), cache
    (B, Smax, Hkv, Dh), pos a (B,) tensor of each row's current position
    (or one int): row b attends to cache[b, :pos[b] + 1]."""
    B, _, H, Dh = q.shape
    Smax, Hkv = cache_k.shape[1], cache_k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(Dh)
    qr = q.reshape(B, Hkv, G, Dh)
    s = _acc_einsum("bhgd,bkhd->bhgk", qr, cache_k) * scale
    pos = torch.as_tensor(pos, device=q.device)
    pos_b = pos.reshape(-1, 1, 1, 1) if pos.dim() else pos
    mask = torch.arange(Smax, device=q.device)[None, None, None, :] <= pos_b
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = _acc_einsum("bhgk,bkhd->bhgd", p.to(cache_v.dtype), cache_v)
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def decode_attention_seqsharded(q: torch.Tensor, cache_k: torch.Tensor,
                                cache_v: torch.Tensor, pos, *, comm
                                ) -> torch.Tensor:
    """Flash-decoding on this rank's shard of a sequence-sharded cache.
    ``cache_k`` / ``cache_v`` (B, S / P, Hkv, Dh) hold the key positions
    ``comm.rank * S_local + arange(S_local)``; q (B, 1, H, Dh) and ``pos``
    are replicated.  Each rank computes a partial softmax over its keys
    (masked scores, local max m, p = exp(s - m), numerator and
    denominator); one max all-reduce gives the global max, and one sum
    all-reduce combines the rescaled packet [num r | den r], r = exp(m -
    gmax), of (B, Hkv, G, Dh + 1) words, in place of gathering the cache.
    A shard whose keys all lie after ``pos`` has m = NEG_INF and p = 1 on
    every key: its rescale r = 0 removes it, as in the reference, whose
    order of operations this keeps.  The statistics are in
    :func:`acc_dtype` (f32, f64 for f64 inputs).  Returns (B, 1, H, Dh)."""
    B, _, H, Dh = q.shape
    S_local, Hkv = cache_k.shape[1], cache_k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(Dh)
    kpos = comm.rank * S_local + torch.arange(S_local, device=q.device)
    s = _acc_einsum("bhgd,bkhd->bhgk", q.reshape(B, Hkv, G, Dh),
                    cache_k) * scale
    pos = torch.as_tensor(pos, device=q.device)
    pos_b = pos.reshape(-1, 1, 1, 1) if pos.dim() else pos
    s = torch.where(kpos[None, None, None, :] <= pos_b, s, NEG_INF)
    m = s.amax(dim=-1)                                   # (B, Hkv, G)
    p = torch.exp(s - m[..., None])
    num = _acc_einsum("bhgk,bkhd->bhgd", p.to(cache_v.dtype), cache_v)
    den = p.sum(dim=-1)
    gmax = comm.all_reduce(m.clone(), op="max")     # m stays the local max
    r = torch.exp(m - gmax)
    packet = torch.cat([num * r[..., None], (den * r)[..., None]], dim=-1)
    packet = comm.all_reduce(packet.contiguous())        # (B, Hkv, G, Dh + 1)
    out = packet[..., :Dh] / torch.clamp_min(packet[..., Dh:], 1e-30)
    return out.reshape(B, 1, H, Dh).to(q.dtype)


# ------------------------------------------------------------------ mlp ----

def mlp_specs(cfg) -> dict:
    d, f, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {
        "w1": ParamSpec((d, f), ("embed", "mlp"), pd),
        "w3": ParamSpec((d, f), ("embed", "mlp"), pd),
        "w2": ParamSpec((f, d), ("mlp", "embed"), pd),
    }


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w1"])
    g = x @ p["w3"]
    return (h * g) @ p["w2"]


# ----------------------------------------------------------- embeddings ----

def embed_specs(cfg) -> dict:
    pd = cfg.param_dtype
    specs = {"embedding": ParamSpec((cfg.padded_vocab, cfg.d_model),
                                    ("vocab", "embed"), pd,
                                    scale=cfg.d_model ** -0.5)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.padded_vocab),
                                     ("embed", "vocab"), pd)
    return specs


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens]


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    if "lm_head" not in p:
        return x @ p["embedding"].T
    return x @ p["lm_head"]
