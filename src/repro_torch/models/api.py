"""Model assembly for the decoder family, the twin of ``repro.models.api``:
the dense decoders (llama, qwen2, granite, mistral-nemo) and the vlm's
patch-prefix path (llava) share one body.

Public entry points (the reference's, with its parameter tree replaced by
a :class:`DecoderLM`):
  param_specs(cfg)                         -> ParamSpec tree
  forward(model, cfg, batch)               -> (logits, aux)
  init_cache_specs(cfg, batch, max_seq)    -> cache ParamSpec tree
  init_cache(cfg, batch, max_seq, device)  -> zero cache
  prefill(model, cfg, batch, max_seq)      -> (logits_last, cache)
  decode_step(model, cfg, cache, tok, pos) -> (logits, cache)

The reference scans one superblock over a stacked layer axis; here the
layers are an ``nn.ModuleList`` and the scan is a Python loop over them.
The parameter tree keeps the stacked layout (``blocks/sub{j}``, layer axis
first) so that counts, bytes and the reference's weights carry over
(``repro_torch.interop.lm_params_from_reference``); each layer's tensors
are views of it.  So does the cache: ``{"blocks": {"sub{j}": {"k", "v"}}}``
with the layer axis first, slot axis second.  ``decode_step`` writes the
new k / v rows into that cache in place and returns it (the reference
returns a new cache).  The reference's ``_remat`` is a training-time
memory policy and has no twin.

The ssm / hybrid bodies (``mamba2.py``), mixture-of-experts MLPs
(``moe.py``) and the encoder-decoder body (audio) are not ported yet: their
entry points raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from . import layers as L
from .module import ParamSpec, init_params, stack_specs, tree_map

UNPORTED = ("ssm", "hybrid", "audio")


def check_ported(cfg, what: str) -> None:
    """Refuse the families whose bodies the port does not have yet."""
    if cfg.family in UNPORTED or cfg.moe is not None:
        part = ("the encoder-decoder body" if cfg.family == "audio" else
                "moe.py" if cfg.moe is not None and cfg.family == "moe" else
                "mamba2.py and moe.py" if cfg.family == "hybrid" else
                "mamba2.py")
        raise NotImplementedError(
            f"{what}: {cfg.name} ({cfg.family}) needs {part}, which the next "
            f"slice of the port brings (ROADMAP.md, queue 1); the port has "
            f"the dense and vlm decoder body only")


# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------


def _superblock_period(cfg) -> int:
    period = cfg.attn_layer_period
    if cfg.moe:
        period = math.lcm(period, cfg.moe.every_n_layers)
    return period


def _sublayer_specs(cfg, i: int) -> dict:
    return {"ln1": L.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
            "attn": L.attention_specs(cfg),
            "ln2": L.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
            "mlp": L.mlp_specs(cfg)}


def _block_specs(cfg) -> dict:
    period = _superblock_period(cfg)
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} not divisible "
                         f"by superblock period {period}")
    sub = {f"sub{j}": _sublayer_specs(cfg, j) for j in range(period)}
    return stack_specs(sub, cfg.n_layers // period)


def param_specs(cfg, experts_only: bool = False) -> dict:
    check_ported(cfg, "param_specs")
    if experts_only:
        return {}
    specs: dict = dict(L.embed_specs(cfg))
    specs["final_norm"] = L.rmsnorm_spec(cfg.d_model, cfg.param_dtype)
    specs["blocks"] = _block_specs(cfg)
    return specs


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DecoderLayer(nn.Module):
    """One decoder layer: ``ln1``, ``attn`` (wq, wk, wv, wo, and bq, bk, bv
    with qkv bias), ``ln2`` and ``mlp`` (w1, w3, w2), as in the reference's
    sublayer tree."""

    def __init__(self, p: dict):
        super().__init__()
        self.ln1 = _frozen(p["ln1"])
        self.attn = nn.ParameterDict({k: _frozen(v)
                                      for k, v in p["attn"].items()})
        self.ln2 = _frozen(p["ln2"])
        self.mlp = nn.ParameterDict({k: _frozen(v)
                                     for k, v in p["mlp"].items()})


class DecoderLM(nn.Module):
    """The decoder LM: ``top`` holds ``embedding`` (and ``lm_head`` when
    the embeddings are untied) and ``final_norm``; ``layers`` the
    ``cfg.n_layers`` decoder layers in order.  Built from a parameter tree in
    the reference's layout (:func:`param_specs`), whose tensors it keeps as
    they are (views, no copy); no gradients are kept."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        check_ported(cfg, "DecoderLM")
        self.cfg = cfg
        self.top = nn.ParameterDict({k: _frozen(params[k]) for k in
                                     ("embedding", "lm_head", "final_norm")
                                     if k in params})
        period = _superblock_period(cfg)
        blocks = params["blocks"]
        self.layers = nn.ModuleList(
            DecoderLayer(tree_map(lambda t, i=i: t[i], blocks[f"sub{j}"],
                                  is_leaf=torch.is_tensor))
            for i in range(cfg.n_layers // period) for j in range(period))

    @classmethod
    def init(cls, cfg, generator: torch.Generator, device=None
             ) -> "DecoderLM":
        """Random weights from ``generator`` (:func:`init_params`)."""
        return cls(cfg, init_params(param_specs(cfg), generator, device))

    @property
    def device(self) -> torch.device:
        return self.top["embedding"].device

    def param_tree(self, dtype: torch.dtype | None = None) -> dict:
        """The parameters in the reference's layout (layer axis stacked),
        copied, in ``dtype`` when given."""
        def conv(t):
            return t.data if dtype is None else t.data.to(dtype)

        period = _superblock_period(self.cfg)
        tree = {k: conv(v).clone() for k, v in self.top.items()}
        tree["blocks"] = {}
        for j in range(period):
            layers = self.layers[j::period]
            tree["blocks"][f"sub{j}"] = _stack(
                [tree_map(conv, _layer_tree(layer), is_leaf=torch.is_tensor)
                 for layer in layers], _layer_tree(layers[0]))
        return tree

    def cast(self, dtype: torch.dtype) -> "DecoderLM":
        """A copy with every parameter and the activations in ``dtype``
        (``cfg.dtype`` and ``cfg.param_dtype`` replaced)."""
        cfg = dataclasses.replace(self.cfg, dtype=dtype, param_dtype=dtype)
        return DecoderLM(cfg, self.param_tree(dtype))

    def forward(self, batch: dict):
        return forward(self, self.cfg, batch)


def _layer_tree(layer: DecoderLayer) -> dict:
    return {"ln1": layer.ln1.data, "ln2": layer.ln2.data,
            "attn": {k: v.data for k, v in layer.attn.items()},
            "mlp": {k: v.data for k, v in layer.mlp.items()}}


def _stack(trees: list, like: dict):
    if isinstance(like, dict):
        return {k: _stack([t[k] for t in trees], like[k]) for k in like}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# Sublayer application
# ---------------------------------------------------------------------------


def _positions(S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :]


def _project(p, x, cfg, positions):
    """q, k, v of self-attention with rope on q and k, k / v repeated over
    the padded q heads when ``cfg.q_head_pad`` (repeated kv is grouped GQA,
    exactly)."""
    q, k, v = L.qkv_proj(p, x)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    if cfg.q_head_pad:
        g = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    return q, k, v


def _apply_layer(layer, x, cfg, positions, kv=None):
    """One decoder layer on x (B, S, D); appends its (k, v) to ``kv`` when
    given (prefill's cache)."""
    h = L.rmsnorm(x, layer.ln1, cfg.norm_eps)
    q, k, v = _project(layer.attn, h, cfg, positions)
    out = L.chunked_attention(q, k, v, causal=True, block_q=cfg.block_q,
                              block_kv=cfg.block_kv)
    x = x + L.out_proj(layer.attn, out)
    if kv is not None:
        kv.append((k, v))
    h = L.rmsnorm(x, layer.ln2, cfg.norm_eps)
    return x + L.swiglu(layer.mlp, h)


def _decoder_stack(model, cfg, x, positions, kv=None):
    """The layers in order (the reference's scan over superblocks)."""
    for layer in model.layers:
        x = _apply_layer(layer, x, cfg, positions, kv)
    return x, {}


def _embed(model, cfg, batch: dict) -> torch.Tensor:
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    x = L.embed(model.top, tokens.long()).to(cfg.dtype)
    extra = batch.get("extra_embeds")
    if extra is not None:
        extra = torch.as_tensor(extra, device=model.device)
        x = torch.cat([extra.to(cfg.dtype), x], dim=1)
    return x


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def forward(model, cfg, batch: dict):
    """Returns (logits (B, S, Vpad), aux metrics).  batch keys: tokens
    (B, St); optional extra_embeds (B, Sx, D) prefixed (the vlm's patch
    embeddings)."""
    check_ported(cfg, "forward")
    x = _embed(model, cfg, batch)
    x, aux = _decoder_stack(model, cfg, x, _positions(x.shape[1], x.device))
    x = L.rmsnorm(x, model.top["final_norm"], cfg.norm_eps)
    return L.unembed(model.top, x), aux


# ---------------------------------------------------------------------------
# KV caches and decode
# ---------------------------------------------------------------------------


def init_cache_specs(cfg, batch: int, max_seq: int) -> dict:
    """ParamSpec tree of the decode cache, the reference's layout."""
    check_ported(cfg, "init_cache_specs")
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (batch, max_seq, hkv, dh)
    axes = ("batch", "cache_seq", "kv_heads", "head_dim")
    sub = {f"sub{j}": {"k": ParamSpec(shape, axes, cfg.dtype, init="zeros"),
                       "v": ParamSpec(shape, axes, cfg.dtype, init="zeros")}
           for j in range(_superblock_period(cfg))}
    return {"blocks": stack_specs(sub, cfg.n_layers // _superblock_period(cfg))}


def init_cache(cfg, batch: int, max_seq: int, device) -> dict:
    """A zero cache of :func:`init_cache_specs` on ``device``."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    init_cache_specs(cfg, batch, max_seq))


def _layer_cache(cache: dict, cfg, i: int) -> tuple:
    """(k, v) of layer i: views into the stacked cache."""
    period = _superblock_period(cfg)
    c = cache["blocks"][f"sub{i % period}"]
    return c["k"][i // period], c["v"][i // period]


def decode_step(model, cfg, cache: dict, token: torch.Tensor,
                pos: torch.Tensor):
    """One decode step.  token (B,) integer, pos (B,) current positions.
    Writes each layer's new k / v row at ``pos`` into ``cache`` in place.
    Returns (logits (B, Vpad), cache)."""
    check_ported(cfg, "decode_step")
    dev = model.device
    token = torch.as_tensor(token, device=dev).long()
    pos = torch.as_tensor(pos, device=dev).long()
    rows = torch.arange(token.shape[0], device=dev)
    x = L.embed(model.top, token[:, None]).to(cfg.dtype)    # (B, 1, D)
    for i, layer in enumerate(model.layers):
        ck, cv = _layer_cache(cache, cfg, i)
        h = L.rmsnorm(x, layer.ln1, cfg.norm_eps)
        q, k, v = L.qkv_proj(layer.attn, h)
        q = L.rope(q, pos[:, None], cfg.rope_theta)
        k = L.rope(k, pos[:, None], cfg.rope_theta)
        ck[rows, pos] = k[:, 0].to(ck.dtype)
        cv[rows, pos] = v[:, 0].to(cv.dtype)
        x = x + L.out_proj(layer.attn, L.decode_attention(q, ck, cv, pos))
        h = L.rmsnorm(x, layer.ln2, cfg.norm_eps)
        x = x + L.swiglu(layer.mlp, h)
    x = L.rmsnorm(x, model.top["final_norm"], cfg.norm_eps)
    return L.unembed(model.top, x)[:, 0, :], cache


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(model, cfg, batch: dict, max_seq: int | None = None):
    """Run the full-context forward and build the decode cache: every
    layer's rope'd k and its v, zero-padded from S to ``max_seq``.  Returns
    (logits at the last position (B, Vpad), cache)."""
    check_ported(cfg, "prefill")
    x = _embed(model, cfg, batch)
    B, S = x.shape[:2]
    max_seq = max_seq or S
    kv: list = []
    x, _ = _decoder_stack(model, cfg, x, _positions(S, x.device), kv)
    x = L.rmsnorm(x, model.top["final_norm"], cfg.norm_eps)
    logits = L.unembed(model.top, x[:, -1:, :])[:, 0, :]
    cache = init_cache(cfg, B, max_seq, x.device)
    for i, (k, v) in enumerate(kv):
        ck, cv = _layer_cache(cache, cfg, i)
        ck[:, :S] = k.to(ck.dtype)
        cv[:, :S] = v.to(cv.dtype)
    return logits, cache
