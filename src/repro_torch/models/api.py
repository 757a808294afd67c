"""Model assembly, the twin of ``repro.models.api``: every architecture
reduces to one of two bodies

  * decoder -- dense / moe / ssm / hybrid / vlm (:class:`DecoderLM`; llava
               = decoder + patch prefix; mamba2 = decoder with mamba
               sublayers and no MLP; jamba = 1:7 attn:mamba interleave with
               MoE on every other layer)
  * encdec  -- seamless (:class:`EncDecLM`: audio encoder + cross-attending
               text decoder)

Public entry points (the reference's, with its parameter tree replaced by
a model built from it, :func:`build_model`):
  param_specs(cfg[, expert_shard])         -> ParamSpec tree
  forward(model, cfg, batch[, comm])       -> (logits, aux)
  loss_fn(model, cfg, batch[, comm])       -> (loss, metrics)
  init_cache_specs(cfg, batch, max_seq)    -> cache ParamSpec tree
  init_cache(cfg, batch, max_seq, device[, grid, seq_shard])
                                           -> zero cache (a rank's block)
  prefill(model, cfg, batch, max_seq[, seq_shard])
                                           -> (logits_last, cache)
  decode_step(model, cfg, cache, tok, pos[, comm, expert_comm, seq_shard])
                                           -> (logits, cache)
  shard_cache(cache, cfg, rank, n_shards)  -> a rank's sequence shard
  cut_cache(cache, cfg, grid, coords[, seq_shard])
                                           -> a rank's block on a grid
  grid_model(cfg, params, comm)            -> a rank's model on a grid

The reference scans one superblock (the lcm of the attention interleave
and the MoE period) over a stacked layer axis; here the layers are an
``nn.ModuleList`` and the scan is a Python loop over them, so a layer holds
only its own sublayers: ``attn`` or ``mamba``, then ``mlp``, ``moe`` or
nothing (``d_ff == 0``).  The parameter tree keeps the stacked layout
(``blocks/sub{j}``, or ``encoder`` / ``decoder`` for the enc-dec body,
layer axis first) so that counts, bytes and the reference's weights carry
over (``repro_torch.interop.lm_params_from_reference``); each layer's
tensors are views of it.  So does the cache: ``{"blocks": {"sub{j}":
{"k", "v"} or {"ssm", "conv_x", "conv_B", "conv_C"}}}`` or ``{"decoder":
{"k", "v", "xk", "xv"}}``, layer axis first, slot axis second.
``decode_step`` writes each layer's new k / v rows and mamba state into
that cache in place and returns it (the reference returns a new cache).

Decode also runs on a sequence-sharded cache (``seq_shards=P`` in the
cache specs, :func:`shard_cache`, ``decode_step(..., comm=...)``): every
attention layer's k / v holds S / P positions on a rank, a new row is
written only on the rank that owns its position, and self-attention is
flash-decoding (``layers.decode_attention_seqsharded``: two all-reduces a
layer); the mamba state, the MLP / MoE, the norms and the logits are
replicated, and the audio family's cross cache of encoder frames stays
whole.  The reference shards its dry run's decode cache over 'model' and
lets GSPMD place the collective; the port passes the rank's communicator.

An MoE model's experts may be sharded over a world of P ranks (the
reference's ``"expert": ("model",)``): :func:`param_specs` /
:func:`init_model` with ``expert_shard=(rank, P)`` give a rank E / P
experts of every MoE layer (w1 / w3 / w2 cut on the expert axis of the
stacked layout), and ``forward`` / ``nll_sum`` / ``loss_fn`` / ``prefill``
take the rank's ``comm`` (its rows of the global batch, or with
``replicated`` the same tokens on every rank) and ``decode_step`` an
``expert_comm`` (replicated tokens): the dispatch is the global one
(``models.moe``).  Everything but the experts stays whole on every rank
(the reference shards dbrx's and jamba's other weights FSDP-style over
'data'; the port replicates them).

On a grid of ranks (:class:`GridLayout`, the reference's production
layout; section "A grid of ranks" below) the dense decoder, the vlm, the
encoder-decoder and the ssm family train and serve: ``prefill`` and
``decode_step`` of a rank's model (:func:`grid_model`) take the rank's
(pod, data) rows and give the logits of its vocab columns, and the
decode cache is cut as the reference's ``decode_specs`` cut it
(:func:`cache_shardings`): by default its positions over 'model'
(``cache_seq: ("model",)``; flash-decoding over the 'model' group), with
``seq_shard=False`` its kv heads (Megatron's decode).

Serving keeps the parameters frozen.  Training calls
:meth:`_LM.trainable`: every parameter requires grad, and backward adds
each gradient in place into buffers laid out as the parameter tree
(:meth:`_LM.grad_tree`), so the optimizer and the checkpoint see the
reference's layout.  The reference's ``_remat`` becomes :func:`_remat`:
with gradients on, each superblock (each layer of the enc-dec body) runs
under ``torch.utils.checkpoint``, saving nothing (``cfg.remat == "full"``)
or only the products without batch dimensions (``"dots"``); ``"none"``
keeps every activation.  The memory policy moves no bit of the loss or of
a gradient.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.core.collectives import copy_to, gather_from, reduce_from
from . import layers as L
from . import mamba2 as M
from . import moe as MOE
from .module import (ParamSpec, init_params, is_spec, stack_specs, tree_leaves,
                     tree_map)
from repro_torch.core.grid import as_grid
from .sharding import (cut_tree, entry_axes, make_rules, map_specs,
                       shard_shape)

# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------


def _superblock_period(cfg) -> int:
    period = cfg.attn_layer_period
    if cfg.moe:
        period = math.lcm(period, cfg.moe.every_n_layers)
    return period


def _sublayer_specs(cfg, i: int, n_ranks: int = 1) -> dict:
    specs: dict = {"ln1": L.rmsnorm_spec(cfg.d_model, cfg.param_dtype)}
    if cfg.layer_kind(i) == "attn":
        specs["attn"] = L.attention_specs(cfg)
    else:
        specs["mamba"] = M.mamba_specs(cfg)
    if cfg.d_ff > 0:
        specs["ln2"] = L.rmsnorm_spec(cfg.d_model, cfg.param_dtype)
        if cfg.mlp_kind(i) == "moe":
            specs["moe"] = MOE.moe_specs(cfg, n_ranks)
        else:
            specs["mlp"] = L.mlp_specs(cfg)
    return specs


def _block_specs(cfg, n_ranks: int = 1) -> dict:
    period = _superblock_period(cfg)
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} not divisible "
                         f"by superblock period {period}")
    sub = {f"sub{j}": _sublayer_specs(cfg, j, n_ranks) for j in range(period)}
    return stack_specs(sub, cfg.n_layers // period)


def _encdec_specs(cfg) -> dict:
    # Encoder: bidirectional attn + MLP; decoder: self-attn + cross-attn + MLP.
    enc_layer = {
        "ln1": L.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "attn": L.attention_specs(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "mlp": L.mlp_specs(cfg),
    }
    dec_layer = {
        "ln1": L.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "attn": L.attention_specs(cfg),
        "lnx": L.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "cross": L.attention_specs(cfg, cross=True),
        "ln2": L.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "mlp": L.mlp_specs(cfg),
    }
    return {
        "encoder": stack_specs(enc_layer, cfg.enc_layers),
        "enc_norm": L.rmsnorm_spec(cfg.d_model, cfg.param_dtype),
        "decoder": stack_specs(dec_layer, cfg.n_layers),
    }


def _shards(cfg, expert_shard) -> int:
    """The ranks the experts are sharded over (1 for none or no MoE)."""
    if expert_shard is None or not cfg.moe:
        return 1
    rank, n_ranks = expert_shard
    MOE.expert_range(cfg.moe.num_experts, rank, n_ranks)   # E % P checked
    return n_ranks


def param_specs(cfg, experts_only: bool = False,
                expert_shard: tuple | None = None) -> dict:
    """The parameter tree's specs; with ``expert_shard=(rank, P)`` a rank's
    shard of experts sharded over P ranks (``models.moe``): every MoE
    leaf w1 / w3 / w2 holds E / P experts, the rest is whole."""
    n_ranks = _shards(cfg, expert_shard)
    if experts_only:
        if not cfg.moe:
            return {}
        moe_layers = cfg.n_layers // cfg.moe.every_n_layers
        e = MOE.moe_specs(cfg, n_ranks)
        return stack_specs({k: e[k] for k in ("w1", "w2", "w3")}, moe_layers)
    specs: dict = dict(L.embed_specs(cfg))
    specs["final_norm"] = L.rmsnorm_spec(cfg.d_model, cfg.param_dtype)
    if cfg.family == "audio":
        specs.update(_encdec_specs(cfg))
    else:
        specs["blocks"] = _block_specs(cfg, n_ranks)
    return specs


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Layer(nn.Module):
    """One layer's parameters, in the reference's sublayer tree: the norms
    (``ln1``, ``ln2``, ``lnx``) as parameters, the sublayers (``attn``,
    ``cross``, ``mamba``, ``mlp``, ``moe``) as parameter dicts.  ``kinds``
    names the entries this layer has."""

    def __init__(self, p: dict):
        super().__init__()
        self.kinds = tuple(p)
        for k, v in p.items():
            setattr(self, k, nn.ParameterDict(
                {n: _frozen(t) for n, t in v.items()})
                if isinstance(v, dict) else _frozen(v))

    def tree(self, leaf=lambda p: p.data) -> dict:
        """The layer's tree of ``leaf(parameter)`` (default: the data)."""
        out = {}
        for k in self.kinds:
            v = getattr(self, k)
            out[k] = ({n: leaf(t) for n, t in v.items()}
                      if isinstance(v, nn.ParameterDict) else leaf(v))
        return out


def _unstack(stacked: dict, n: int) -> list:
    """The n layer trees of a stacked tree (views along the layer axis)."""
    return [tree_map(lambda t, i=i: t[i], stacked, is_leaf=torch.is_tensor)
            for i in range(n)]


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _to_specs(tree, specs):
    """Each leaf of ``tree`` in the dtype of its spec (a copy where the
    dtype changes)."""
    if is_spec(specs):
        return tree.to(specs.dtype)
    return {k: _to_specs(tree[k], specs[k]) for k in tree}


def _nest(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class _LM(nn.Module):
    """What both bodies share: ``top`` holds ``embedding`` (and ``lm_head``
    when the embeddings are untied), ``final_norm`` and any other unstacked
    leaf; the subclass holds the layers and knows their stacked layout
    (:meth:`_groups`).  Built from a parameter tree in the reference's
    layout (:func:`param_specs`), whose tensors it keeps as they are
    (views, no copy), frozen; :meth:`trainable` turns gradients on."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        self.top = nn.ParameterDict({k: _frozen(v) for k, v in params.items()
                                     if torch.is_tensor(v)})
        self._grads = None
        self.layout = None

    @classmethod
    def init(cls, cfg, generator: torch.Generator, device=None):
        """Random weights from ``generator`` (:func:`init_params`)."""
        return cls(cfg, init_params(param_specs(cfg), generator, device))

    @property
    def device(self) -> torch.device:
        return self.top["embedding"].device

    def _groups(self) -> list:
        """(path in the parameter tree, layers stacked there in order)."""
        raise NotImplementedError

    def _stacks(self) -> dict:
        tree: dict = {}
        for path, layers in self._groups():
            _nest(tree, path, _stack([la.tree() for la in layers]))
        return tree

    def param_tree(self, dtype: torch.dtype | None = None) -> dict:
        """The parameters in the reference's layout (layer axes stacked),
        copied; with ``dtype``, each leaf in the type its spec gives a model
        of that dtype (the f32 parameters -- mamba's ``A_log``, ``D``,
        ``dt_bias``, the MoE router -- stay f32, as in the reference)."""
        tree = {k: v.data.clone() for k, v in self.top.items()}
        tree.update(self._stacks())
        if dtype is None:
            return tree
        cfg = dataclasses.replace(self.cfg, dtype=dtype, param_dtype=dtype)
        return _to_specs(tree, param_specs(cfg))

    def trainable(self) -> "_LM":
        """Turn gradients on, for training: every parameter requires grad,
        and its ``.grad`` is a view of a zero buffer laid out as
        :meth:`param_tree` (each in its parameter's dtype), so that backward
        adds each layer's gradient there in place.  Returns the model."""
        self.requires_grad_(True)
        grads = {k: torch.zeros_like(v) for k, v in self.top.items()}
        for k, v in self.top.items():
            v.grad = grads[k]
        for path, layers in self._groups():
            bufs = tree_map(lambda t, n=len(layers): t.new_zeros(
                (n,) + t.shape), layers[0].tree(), is_leaf=torch.is_tensor)
            for i, la in enumerate(layers):
                for k, v in la.tree(lambda p: p).items():
                    if isinstance(v, dict):
                        for n, t in v.items():
                            t.grad = bufs[k][n][i]
                    else:
                        v.grad = bufs[k][i]
            _nest(grads, path, bufs)
        self._grads = grads
        return self

    def grad_tree(self) -> dict:
        """The gradients in the reference's layout: the live buffers of
        :meth:`trainable` (not copies)."""
        if self._grads is None:
            raise RuntimeError("the model is frozen: call trainable() first")
        return self._grads

    def zero_grad_tree(self) -> None:
        """Zero the gradient buffers in place (they stay the parameters'
        ``.grad``)."""
        for g in tree_leaves(self.grad_tree(), is_leaf=torch.is_tensor):
            g.zero_()

    def cast(self, dtype: torch.dtype) -> "_LM":
        """A copy with the activations and the parameters in ``dtype``
        (``cfg.dtype`` and ``cfg.param_dtype`` replaced; f32 parameters
        stay f32, :meth:`param_tree`)."""
        cfg = dataclasses.replace(self.cfg, dtype=dtype, param_dtype=dtype)
        return type(self)(cfg, self.param_tree(dtype))

    def forward(self, batch: dict):
        return forward(self, self.cfg, batch)


class DecoderLM(_LM):
    """The decoder LM: ``layers`` holds the ``cfg.n_layers`` layers in
    order, layer i = superblock i // period, sublayer ``sub{i % period}``
    of the stacked tree; each holds ``attn`` or ``mamba``, and ``mlp``,
    ``moe`` or nothing, as ``cfg.layer_kind`` / ``cfg.mlp_kind`` say."""

    def __init__(self, cfg, params: dict):
        super().__init__(cfg, params)
        if cfg.family == "audio":
            raise ValueError(f"{cfg.name} is an encoder-decoder: EncDecLM, "
                             f"or build_model, builds it")
        period = _superblock_period(cfg)
        subs = [_unstack(params["blocks"][f"sub{j}"], cfg.n_layers // period)
                for j in range(period)]
        self.layers = nn.ModuleList(Layer(subs[i % period][i // period])
                                    for i in range(cfg.n_layers))

    def _groups(self) -> list:
        period = _superblock_period(self.cfg)
        return [(("blocks", f"sub{j}"), self.layers[j::period])
                for j in range(period)]


class EncDecLM(_LM):
    """The encoder-decoder LM (audio family): ``enc_layers`` (``ln1``,
    ``attn``, ``ln2``, ``mlp``), ``enc_norm`` in ``top``, and
    ``dec_layers`` (``ln1``, ``attn``, ``lnx``, ``cross``, ``ln2``,
    ``mlp``)."""

    def __init__(self, cfg, params: dict):
        super().__init__(cfg, params)
        if cfg.family != "audio":
            raise ValueError(f"{cfg.name} is a decoder: DecoderLM, or "
                             f"build_model, builds it")
        self.enc_layers = nn.ModuleList(
            Layer(t) for t in _unstack(params["encoder"], cfg.enc_layers))
        self.dec_layers = nn.ModuleList(
            Layer(t) for t in _unstack(params["decoder"], cfg.n_layers))

    def _groups(self) -> list:
        return [(("encoder",), self.enc_layers),
                (("decoder",), self.dec_layers)]


def build_model(cfg, params: dict, layout: "GridLayout | None" = None
                ) -> _LM:
    """The model of ``cfg``'s body on a parameter tree of
    :func:`param_specs`' layout: :class:`EncDecLM` for the audio family,
    else :class:`DecoderLM`.  ``layout``: the tree is a rank's blocks on a
    grid (:class:`GridLayout`), and the model's forward is the rank's
    part of the tensor-parallel / FSDP forward."""
    model = (EncDecLM if cfg.family == "audio" else DecoderLM)(cfg, params)
    model.layout = layout
    return model


def init_model(cfg, generator: torch.Generator, device=None,
               expert_shard: tuple | None = None) -> _LM:
    """:func:`build_model` on random weights from ``generator``; with
    ``expert_shard=(rank, P)`` the rank's shard of the expert-by-expert
    stream (:func:`init_shard`: the shards of P ranks join into the ``(0,
    1)`` draw)."""
    return build_model(cfg, init_shard(param_specs(cfg), generator, device,
                                       cfg, expert_shard))


def init_shard(specs, generator: torch.Generator, device, cfg,
               expert_shard: tuple | None):
    """:func:`init_params` of the whole tree ``specs``; with
    ``expert_shard=(rank, P)`` and an MoE model, each expert leaf drawn one
    expert's matrix at a time, keeping the rank's experts (the other
    matrices are drawn and dropped): the same stream for every P, which
    never holds another rank's experts."""
    if expert_shard is None or not cfg.moe:
        return init_params(specs, generator, device)
    rank, n_ranks = expert_shard
    return init_params(specs, generator, device, experts=MOE.expert_range(
        cfg.moe.num_experts, rank, n_ranks))


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


def _attend(q, k, v, cfg, causal=True):
    return L.chunked_attention(q, k, v, causal=causal, block_q=cfg.block_q,
                               block_kv=cfg.block_kv)


def _apply_layer(layer, x, cfg, positions, aux, caches=None, ep=None,
                 lay=None):
    """One decoder layer on x (B, S, D); sums the MoE metrics into ``aux``;
    appends the layer's decode cache to ``caches`` when given (prefill's:
    an attention layer's rope'd k and its v, a mamba layer's state).
    ``ep``: ``(comm, replicated)`` of experts sharded over ranks, or
    ``None``.  ``lay``: the rank's :class:`GridLayout` (a dense or mamba
    layer, :func:`_grid_layer`; prefill's cache holds the kv heads, or
    the block of the mamba state, the rank holds; no experts)."""
    if lay is not None:
        return _grid_layer(lay.layer_tree(layer), x, cfg, positions, lay,
                           caches), aux
    h = L.rmsnorm(x, layer.ln1, cfg.norm_eps)
    if "attn" in layer.kinds:
        q, k, v = _project(layer.attn, h, cfg, positions)
        x = x + L.out_proj(layer.attn, _attend(q, k, v, cfg))
        state = {"k": k, "v": v}
    else:
        out, state = M.mamba_block_with_state(layer.mamba, h, cfg)
        x = x + out
    if caches is not None:
        caches.append(state)
    if "ln2" in layer.kinds:
        h = L.rmsnorm(x, layer.ln2, cfg.norm_eps)
        if "moe" in layer.kinds:
            out, metrics = MOE.moe_block(layer.moe, h, cfg, *(ep or ()))
            aux = {k: aux.get(k, 0.0) + v for k, v in metrics.items()}
            x = x + out
        else:
            x = x + L.swiglu(layer.mlp, h)
    return x, aux


# The products without batch dimensions (the projections, the MLP, the
# unembedding): what jax's ``dots_with_no_batch_dims_saveable`` keeps.  An
# einsum with no batch dimension runs as a ``bmm`` over a batch of one.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    if op in _DOTS or (op is torch.ops.aten.bmm.default
                       and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg, model):
    """The reference's ``_remat``: ``fn`` under activation checkpointing
    while gradients flow to the model's parameters -- ``"full"`` saves
    nothing and recomputes ``fn`` in backward, ``"dots"`` saves only the
    products without batch dimensions; ``"none"``, or no gradients, runs
    ``fn`` as it is.  On a grid with FSDP (:class:`GridLayout`), ``"none"``
    runs as ``"full"``: a layer's gathered weights are freed after its
    forward and gathered again when backward recomputes it."""
    remat = cfg.remat
    if remat == "none" and model.layout is not None and model.layout.fsdp:
        remat = "full"      # FSDP gathers a layer's weights again in backward
    if (remat == "none" or not torch.is_grad_enabled()
            or not model.top["embedding"].requires_grad):
        return fn
    if remat not in ("full", "dots"):
        raise ValueError(f"remat={remat!r} must be 'full', 'dots' or "
                         "'none'")
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if remat == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _dots_policy)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _apply_layers(layers, x, cfg, positions, aux, caches=None, ep=None,
                  lay=None):
    for layer in layers:
        x, aux = _apply_layer(layer, x, cfg, positions, aux, caches, ep, lay)
    return x, aux


def _expert_parallel(cfg, comm, replicated: bool):
    """The ``ep`` argument of the layers: ``(comm, replicated)`` when an
    MoE model's experts are sharded over more than one rank."""
    if comm is None or not cfg.moe or comm.size == 1:
        return None
    return (comm, replicated)


def _decoder_stack(model, cfg, x, positions, caches=None, ep=None):
    """The layers in order (the reference's scan over superblocks, each
    superblock under :func:`_remat`); the MoE metrics summed over the MoE
    layers, from f32 zeros."""
    aux = ({k: torch.zeros((), dtype=torch.float32, device=x.device)
            for k in ("moe_aux_loss", "moe_drop_frac")} if cfg.moe else {})
    period = _superblock_period(cfg)
    block = _remat(_apply_layers, cfg, model)
    for i in range(0, len(model.layers), period):
        x, aux = block(model.layers[i:i + period], x, cfg, positions, aux,
                       caches, ep, model.layout)
    return x, aux


def _self_attention(p, x, cfg, positions, causal):
    q, k, v = _project(p, x, cfg, positions)
    return L.out_proj(p, _attend(q, k, v, cfg, causal))


def _encoder_layer(layer, x, cfg, positions, lay=None):
    """One encoder layer; ``lay``: the rank's :class:`GridLayout`."""
    if lay is not None:
        return _grid_encoder_layer(lay.layer_tree(layer), x, cfg, positions,
                                   lay)
    h = L.rmsnorm(x, layer.ln1, cfg.norm_eps)
    x = x + _self_attention(layer.attn, h, cfg, positions, causal=False)
    h = L.rmsnorm(x, layer.ln2, cfg.norm_eps)
    return x + L.swiglu(layer.mlp, h)


def _encoder_stack(model, cfg, src, top=None):
    """The bidirectional encoder on the frame embeddings (each layer under
    :func:`_remat`), then enc_norm (``top``'s on a grid: gathered under
    FSDP)."""
    x = torch.as_tensor(src, device=model.device).to(cfg.dtype)
    positions = _positions(x.shape[1], x.device)
    block = _remat(_encoder_layer, cfg, model)
    for layer in model.enc_layers:
        x = block(layer, x, cfg, positions, model.layout)
    top = model.top if top is None else top
    return L.rmsnorm(x, top["enc_norm"], cfg.norm_eps)


def _cross_decoder_layer(layer, x, cfg, positions, enc, caches=None,
                         lay=None):
    """One decoder layer of the enc-dec body; ``lay``: the rank's
    :class:`GridLayout`."""
    if lay is not None:
        return _grid_cross_layer(lay.layer_tree(layer), x, cfg, positions,
                                 enc, lay, caches)
    h = L.rmsnorm(x, layer.ln1, cfg.norm_eps)
    q, k, v = _project(layer.attn, h, cfg, positions)
    x = x + L.out_proj(layer.attn, _attend(q, k, v, cfg))
    h = L.rmsnorm(x, layer.lnx, cfg.norm_eps)
    qx, xk, xv = L.qkv_proj(layer.cross, h, enc)
    x = x + L.out_proj(layer.cross, _attend(qx, xk, xv, cfg, causal=False))
    h = L.rmsnorm(x, layer.ln2, cfg.norm_eps)
    x = x + L.swiglu(layer.mlp, h)
    if caches is not None:
        caches.append({"k": k, "v": v, "xk": xk, "xv": xv})
    return x


def _cross_decoder_stack(model, cfg, x, enc, caches=None):
    """The text decoder: causal self-attention, cross-attention to the
    encoder's output, MLP (each layer under :func:`_remat`).  Appends each
    layer's self k / v and cross xk / xv to ``caches`` when given.  On a
    grid whose q heads are cut over 'model', the encoder's output (whole
    on every model rank) enters the tensor-parallel regions once: its
    gradient, summed over the layers, is all-reduced over 'model' once."""
    lay = model.layout
    if lay is not None and lay.tp_heads:
        enc = copy_to(enc, lay.model)
    positions = _positions(x.shape[1], x.device)
    block = _remat(_cross_decoder_layer, cfg, model)
    for layer in model.dec_layers:
        x = block(layer, x, cfg, positions, enc, caches, lay)
    return x, {}


def _embed(model, cfg, batch: dict, top=None) -> torch.Tensor:
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    if model.layout is not None:
        x = model.layout.embed(top, tokens.long()).to(cfg.dtype)
    else:
        x = L.embed(model.top, tokens.long()).to(cfg.dtype)
    extra = batch.get("extra_embeds")
    if extra is not None:
        extra = torch.as_tensor(extra, device=model.device)
        x = torch.cat([extra.to(cfg.dtype), x], dim=1)
    return x


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------


def forward(model, cfg, batch: dict, comm=None, replicated: bool = False):
    """Returns (logits (B, S, Vpad), aux metrics).  batch keys: tokens
    (B, St); optional extra_embeds (B, Sx, D) prefixed (the vlm's patch
    embeddings); the audio family instead takes src_embeds (B, Se, D), the
    encoder's frames, with the tokens.  ``comm``: this rank's handle on a
    world over which an MoE model's experts are sharded (the model holds
    the rank's shard, :func:`param_specs`); the batch is the rank's rows
    of the global batch, whose dispatch is one (``models.moe``), or with
    ``replicated`` the same batch on every rank.  On a grid
    (``model.layout``) the logits are the rank's vocab columns when the
    vocab is cut over 'model'."""
    lay = model.layout
    top = model.top if lay is None else lay.top_tree(model)
    if cfg.family == "audio":
        enc = _encoder_stack(model, cfg, batch["src_embeds"], top)
        x, aux = _cross_decoder_stack(model, cfg,
                                      _embed(model, cfg, batch, top), enc)
    else:
        x = _embed(model, cfg, batch, top)
        x, aux = _decoder_stack(model, cfg, x,
                                _positions(x.shape[1], x.device),
                                ep=_expert_parallel(cfg, comm, replicated))
    x = L.rmsnorm(x, top["final_norm"], cfg.norm_eps)
    return (L.unembed(top, x) if lay is None else lay.unembed(top, x)), aux


def nll_sum(model, cfg, batch: dict, comm=None):
    """(sum of the masked next-token NLL over the text positions, the mask's
    sum, the forward's aux metrics): :func:`loss_fn`'s parts, so that a
    data-parallel rank can divide its rows' sum by the global batch's
    count.  The cross entropy runs in ``layers.acc_dtype`` of the logits:
    f32 for bf16 and f32 models (the reference's f32), f64 for f64
    models.  ``comm``: experts sharded over the ranks, the batch this
    rank's rows (:func:`forward`): the MoE metrics are the global
    batch's."""
    logits, aux = forward(model, cfg, batch, comm)
    dev = logits.device
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    St = labels.shape[1]
    logits = logits[:, -St:, :].to(L.acc_dtype(logits.dtype))  # text only
    if model.layout is not None and model.layout.tp_vocab:
        nll = model.layout.nll(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels[..., None],
                                    dim=-1)[..., 0]
        nll = logz - gold
    mask = batch.get("mask")
    mask = (torch.ones_like(nll) if mask is None else
            torch.as_tensor(mask, device=dev).to(nll.dtype))
    return (nll * mask).sum(), mask.sum(), aux


def loss_fn(model, cfg, batch: dict, comm=None):
    """Next-token cross entropy with masking (:func:`nll_sum` over
    max(mask sum, 1)), the MoE aux loss added: (total, {"loss",
    "ppl_log"[, "moe_aux_loss"]}).  With ``comm`` (experts sharded over
    the ranks, the batch this rank's rows) the loss is the rank's rows'
    and the aux loss the global batch's; ``train.make_train_step`` builds
    the world's loss from :func:`nll_sum`."""
    total_nll, n, aux = nll_sum(model, cfg, batch, comm)
    loss = total_nll / torch.clamp_min(n, 1)
    metrics = {"loss": loss, "ppl_log": loss}
    total = loss
    if aux.get("moe_aux_loss") is not None and cfg.moe:
        total = total + aux["moe_aux_loss"] / max(
            cfg.n_layers // cfg.moe.every_n_layers, 1)
        metrics["moe_aux_loss"] = aux["moe_aux_loss"]
    return total, metrics


# ---------------------------------------------------------------------------
# Caches and decode
# ---------------------------------------------------------------------------


def _cache_sublayer_specs(cfg, i: int, batch: int, max_seq: int) -> dict:
    if cfg.layer_kind(i) == "attn":
        hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
        shape = (batch, max_seq, hkv, dh)
        axes = ("batch", "cache_seq", "kv_heads", "head_dim")
        return {"k": ParamSpec(shape, axes, cfg.dtype, init="zeros"),
                "v": ParamSpec(shape, axes, cfg.dtype, init="zeros")}
    s = cfg.ssm
    di, h, gn = (s.d_inner(cfg.d_model), s.n_heads(cfg.d_model),
                 s.n_groups * s.d_state)
    return {
        "ssm": ParamSpec((batch, h, s.head_dim, s.d_state),
                         ("batch", "inner", "head_dim", "state"),
                         torch.float32, init="zeros"),
        "conv_x": ParamSpec((batch, s.d_conv - 1, di),
                            ("batch", "conv", "inner"), cfg.dtype,
                            init="zeros"),
        "conv_B": ParamSpec((batch, s.d_conv - 1, gn),
                            ("batch", "conv", "state"), cfg.dtype,
                            init="zeros"),
        "conv_C": ParamSpec((batch, s.d_conv - 1, gn),
                            ("batch", "conv", "state"), cfg.dtype,
                            init="zeros"),
    }


def _shard_len(max_seq: int, seq_shards: int) -> int:
    if seq_shards < 1 or max_seq % seq_shards:
        raise ValueError(f"max_seq={max_seq} does not split into "
                         f"seq_shards={seq_shards} equal shards")
    return max_seq // seq_shards


def cross_frames(max_seq: int) -> int:
    """The encoder frames the decode cache's cross k / v hold for a cache
    of ``max_seq`` positions: the reference's max(max_seq // 4, 128)."""
    return max(max_seq // 4, 128)


def init_cache_specs(cfg, batch: int, max_seq: int,
                     seq_shards: int = 1) -> dict:
    """ParamSpec tree of the decode cache, the reference's layout.  The
    audio family's cross k / v are sized for max(max_seq // 4, 128) frames,
    as the reference sizes them (its prefill returns them at the encoder's
    own length).  With ``seq_shards=P`` it is one rank's shard of a
    sequence-sharded cache: every self-attention k / v holds max_seq / P
    positions; the cross k / v and the mamba state stay whole."""
    local = _shard_len(max_seq, seq_shards)
    if cfg.family == "audio":
        hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
        self_shape = (batch, local, hkv, dh)
        cross_shape = (batch, cross_frames(max_seq), hkv, dh)
        axes = ("batch", "cache_seq", "kv_heads", "head_dim")
        layer = {"k": ParamSpec(self_shape, axes, cfg.dtype, init="zeros"),
                 "v": ParamSpec(self_shape, axes, cfg.dtype, init="zeros"),
                 "xk": ParamSpec(cross_shape, axes, cfg.dtype, init="zeros"),
                 "xv": ParamSpec(cross_shape, axes, cfg.dtype, init="zeros")}
        return {"decoder": stack_specs(layer, cfg.n_layers)}
    period = _superblock_period(cfg)
    sub = {f"sub{j}": _cache_sublayer_specs(cfg, j, batch, local)
           for j in range(period)}
    return {"blocks": stack_specs(sub, cfg.n_layers // period)}


def cache_rules(cfg, grid, seq_shard: bool = True):
    """The rules that cut the decode cache on ``grid``: the rule table
    (``cfg.fsdp``'s) with the reference's ``cache_seq: ("model",)``
    override when ``seq_shard`` -- the cache's positions over 'model', its
    kv heads then whole on a rank (an axis cuts one dimension of a tensor)
    -- and without it the kv heads over 'model' where they divide.  The
    slots go over (pod, data) either way."""
    return make_rules(grid, fsdp=cfg.fsdp, overrides=(
        {"cache_seq": ("model",)} if seq_shard else None))


def cache_shardings(cfg, batch: int, max_seq: int, grid,
                    seq_shard: bool = True,
                    frames: int | None = None) -> dict:
    """The spec (one entry a dimension, ``models.sharding``) of every leaf
    of the decode cache of ``batch`` slots on ``grid``: :func:`cache_rules`'
    but for the audio family's cross k / v under ``cache_seq``, whose
    ``frames`` (the encoder's; :func:`cross_frames`' count by default, the
    reference's ``decode_specs``) are cut over 'model' only where they
    divide it and are otherwise whole on every model rank, every kv head
    (the rule table would cut their kv heads instead; a cross cache is
    never padded: :func:`_cross_cut`)."""
    tree = cache_rules(cfg, grid, seq_shard).tree(
        init_cache_specs(cfg, batch, max_seq))
    if cfg.family == "audio" and seq_shard:
        F = cross_frames(max_seq) if frames is None else frames
        k = tree["decoder"]["k"]        # (layers, batch, positions, heads, dh)
        cut = F % as_grid(grid)["model"] == 0
        for name in ("xk", "xv"):
            tree["decoder"][name] = k[:2] + ((k[2] if cut else None),) + k[3:]
    return tree


def init_cache(cfg, batch: int, max_seq: int, device,
               seq_shards: int = 1, *, grid=None,
               seq_shard: bool = True) -> dict:
    """A zero cache of :func:`init_cache_specs` on ``device``; on ``grid``
    the block of it that a rank holds (:func:`cache_shardings`: ``batch``
    is the global slot count, cut over (pod, data))."""
    if grid is None:
        return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=device),
                        init_cache_specs(cfg, batch, max_seq, seq_shards))
    grid = as_grid(grid)
    return map_specs(lambda s, sh: torch.zeros(
        shard_shape(s.shape, sh, grid), dtype=s.dtype, device=device),
        init_cache_specs(cfg, batch, max_seq),
        cache_shardings(cfg, batch, max_seq, grid, seq_shard))


def cut_cache(cache: dict, cfg, grid, coords: dict,
              seq_shard: bool = True) -> dict:
    """The block of a whole cache (all slots, every position) that the
    rank at ``coords`` holds on ``grid`` (a copy): :func:`shard_cache`'s
    twin on a grid, the layout of ``init_cache(..., grid=grid)`` (the
    audio family's cross k / v at the frames they hold)."""
    subs = ([cache["decoder"]] if "decoder" in cache
            else list(cache["blocks"].values()))
    leaf = next((s["k"] for s in subs if "k" in s),
                next(iter(subs[0].values())))
    B, S = leaf.shape[1], leaf.shape[2]
    frames = cache["decoder"]["xk"].shape[2] if "decoder" in cache else None
    return cut_tree(cache, cache_shardings(cfg, B, S, grid, seq_shard,
                                           frames), grid, coords)


def shard_cache(cache: dict, cfg, rank: int, n_shards: int) -> dict:
    """Rank ``rank``'s shard of a whole cache (a copy): positions
    ``rank * S / P`` to ``(rank + 1) * S / P`` of every self-attention
    k / v, the cross k / v and the mamba state whole -- the layout of
    ``init_cache_specs(..., seq_shards=n_shards)``."""
    def cut(name, t):
        if name not in ("k", "v"):
            return t.clone()
        local = _shard_len(t.shape[2], n_shards)   # (layers, batch, seq, ...)
        return t[:, :, rank * local:(rank + 1) * local].clone()

    return {group: {sub: ({n: cut(n, t) for n, t in leaves.items()}
                          if isinstance(leaves, dict) else cut(sub, leaves))
                    for sub, leaves in tree.items()}
            for group, tree in cache.items()}


def _layer_cache(cache: dict, cfg, i: int) -> dict:
    """Layer i's cache leaves: views into the stacked cache."""
    if "decoder" in cache:
        return {k: v[i] for k, v in cache["decoder"].items()}
    period = _superblock_period(cfg)
    return {k: v[i // period]
            for k, v in cache["blocks"][f"sub{i % period}"].items()}


def _decode_self_attention(p, c, h, cfg, pos, rows, comm=None):
    """Self-attention of one new token per row at ``pos``: its k / v
    written into the cache views ``c`` in place, then attention to rows
    <= pos.  With ``comm``, ``c`` is this rank's sequence shard: a row's
    k / v is written only where the rank owns ``pos`` (elsewhere the slot
    it would clamp to is rewritten with its own bytes, so nothing waits
    for the device), and attention is flash-decoding over the shards."""
    q, k, v = L.qkv_proj(p, h)
    q = L.rope(q, pos[:, None], cfg.rope_theta)
    k = L.rope(k, pos[:, None], cfg.rope_theta)
    if comm is None:
        c["k"][rows, pos] = k[:, 0].to(c["k"].dtype)
        c["v"][rows, pos] = v[:, 0].to(c["v"].dtype)
        return L.out_proj(p, L.decode_attention(q, c["k"], c["v"], pos))
    S_local = c["k"].shape[1]
    lo = comm.rank * S_local
    own = ((pos >= lo) & (pos < lo + S_local))[:, None, None]
    at = (pos - lo).clamp(0, S_local - 1)
    for name, new in (("k", k), ("v", v)):
        leaf = c[name]
        leaf[rows, at] = torch.where(own, new[:, 0].to(leaf.dtype),
                                     leaf[rows, at])
    return L.out_proj(p, L.decode_attention_seqsharded(
        q, c["k"], c["v"], pos, comm=comm))


def decode_step(model, cfg, cache: dict, token: torch.Tensor,
                pos: torch.Tensor, comm=None, expert_comm=None,
                seq_shard: bool = True, enc_len: int | None = None):
    """One decode step.  token (B,) integer, pos (B,) current positions.
    Writes each layer's new k / v row at ``pos``, and each mamba layer's
    new state, into ``cache`` in place.  Returns (logits (B, Vpad),
    cache).  ``comm``: this rank's handle on a world over which ``cache``
    is sequence-sharded (:func:`shard_cache`; module docstring); token,
    pos and the result are replicated.  ``expert_comm``: this rank's
    handle on a world over which an MoE model's experts are sharded (the
    model holds the rank's shard; every rank decodes the same tokens,
    ``models.moe``'s replicated dispatch).  The two are independent and
    combine: with both (the same world or two), attention is
    flash-decoding over the cache's shards and the MoE layers all-gather
    their experts' outputs, and every rank ends the step with the same
    logits.

    A rank's model on a grid (``model.layout``, :func:`grid_model`) takes
    the rank's (pod, data) rows of token and pos and its block of the cache
    (``init_cache(..., grid=, seq_shard=)``, or :func:`prefill`'s), and
    returns the logits of its vocab columns (:func:`_grid_decode_step`);
    ``comm`` and ``expert_comm`` are then ``None``.  ``enc_len``: the
    audio family's encoder frame count (prefill's ``src_embeds`` length),
    which a rank's model on a grid whose cache's positions are cut over
    'model' needs (the rank's block of the cross cache does not say
    whether its frames were cut: :func:`_cross_cut`); elsewhere the
    cache's cross k / v hold every frame and ``enc_len`` is not read."""
    if model.layout is not None:
        if comm is not None or expert_comm is not None:
            raise ValueError("decode_step on a grid takes the rank's groups "
                             "from its model's layout: comm / expert_comm "
                             "must be None")
        return _grid_decode_step(model, cfg, cache, token, pos, seq_shard,
                                 enc_len)
    dev = model.device
    token = torch.as_tensor(token, device=dev).long()
    pos = torch.as_tensor(pos, device=dev).long()
    rows = torch.arange(token.shape[0], device=dev)
    ep = _expert_parallel(cfg, expert_comm, True)
    x = L.embed(model.top, token[:, None]).to(cfg.dtype)    # (B, 1, D)
    if cfg.family == "audio":
        for i, layer in enumerate(model.dec_layers):
            c = _layer_cache(cache, cfg, i)
            h = L.rmsnorm(x, layer.ln1, cfg.norm_eps)
            x = x + _decode_self_attention(layer.attn, c, h, cfg, pos, rows,
                                           comm)
            h = L.rmsnorm(x, layer.lnx, cfg.norm_eps)
            q, _, _ = L.qkv_proj(layer.cross, h)             # cross k/v cached
            # the reference attends at position enc_len - 1 for every row:
            # every cached frame
            enc_last = torch.full_like(pos, c["xk"].shape[1] - 1)
            x = x + L.out_proj(layer.cross, L.decode_attention(
                q, c["xk"], c["xv"], enc_last))
            h = L.rmsnorm(x, layer.ln2, cfg.norm_eps)
            x = x + L.swiglu(layer.mlp, h)
    else:
        for i, layer in enumerate(model.layers):
            c = _layer_cache(cache, cfg, i)
            h = L.rmsnorm(x, layer.ln1, cfg.norm_eps)
            if "attn" in layer.kinds:
                x = x + _decode_self_attention(layer.attn, c, h, cfg, pos,
                                               rows, comm)
            else:
                out, state = M.mamba_decode_step(layer.mamba, c, h[:, 0], cfg)
                for name, leaf in state.items():
                    c[name].copy_(leaf)
                x = x + out[:, None, :]
            if "ln2" in layer.kinds:
                h = L.rmsnorm(x, layer.ln2, cfg.norm_eps)
                if "moe" in layer.kinds:
                    x = x + MOE.moe_block(layer.moe, h, cfg, *(ep or ()))[0]
                else:
                    x = x + L.swiglu(layer.mlp, h)
    x = L.rmsnorm(x, model.top["final_norm"], cfg.norm_eps)
    return L.unembed(model.top, x)[:, 0, :], cache


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(model, cfg, batch: dict, max_seq: int | None = None,
            comm=None, replicated: bool = False, seq_shard: bool = True):
    """Run the full-context forward and build the decode cache: every
    attention layer's rope'd k and its v, zero-padded from S to
    ``max_seq``, and every mamba layer's state after the last position (the
    chunked scan's final state and the convs' last inputs).  Returns
    (logits at the last position (B, Vpad), cache).  ``comm`` /
    ``replicated``: experts sharded over the ranks, as in :func:`forward`
    (a serving engine's ranks prefill the same request: ``replicated``;
    a data-parallel prefill, each rank its rows).  A rank's model on a
    grid takes the rank's (pod, data) rows and returns the logits of its
    vocab columns and the cache in the decode step's layout
    (:func:`_grid_prefill`; ``seq_shard`` as in :func:`decode_step`)."""
    if model.layout is not None:
        if comm is not None:
            raise ValueError("prefill on a grid takes the rank's groups from "
                             "its model's layout: comm must be None")
        return _grid_prefill(model, cfg, batch, max_seq, seq_shard)
    if cfg.family == "audio":
        return _prefill_encdec(model, cfg, batch, max_seq)
    x = _embed(model, cfg, batch)
    B, S = x.shape[:2]
    max_seq = max_seq or S
    caches: list = []
    x, _ = _decoder_stack(model, cfg, x, _positions(S, x.device), caches,
                          _expert_parallel(cfg, comm, replicated))
    x = L.rmsnorm(x, model.top["final_norm"], cfg.norm_eps)
    logits = L.unembed(model.top, x[:, -1:, :])[:, 0, :]
    cache = init_cache(cfg, B, max_seq, x.device)
    for i, state in enumerate(caches):
        c = _layer_cache(cache, cfg, i)
        for name, leaf in state.items():
            if name in ("k", "v"):
                c[name][:, :S] = leaf.to(c[name].dtype)
            else:
                c[name].copy_(leaf)
    return logits, cache


def _prefill_encdec(model, cfg, batch, max_seq):
    """The audio family's prefill: the encoder on src_embeds, the decoder
    on the tokens; the cache holds each decoder layer's self k / v padded
    to ``max_seq`` and its cross xk / xv at the encoder's own length, as
    the reference's."""
    enc = _encoder_stack(model, cfg, batch["src_embeds"])
    x = _embed(model, cfg, batch)
    S = x.shape[1]
    max_seq = max_seq or S
    caches: list = []
    x, _ = _cross_decoder_stack(model, cfg, x, enc, caches)
    x = L.rmsnorm(x, model.top["final_norm"], cfg.norm_eps)
    logits = L.unembed(model.top, x[:, -1:, :])[:, 0, :]
    pad = (0, 0, 0, 0, 0, max_seq - S)
    layers = [{"k": torch.nn.functional.pad(c["k"], pad),
               "v": torch.nn.functional.pad(c["v"], pad),
               "xk": c["xk"], "xv": c["xv"]} for c in caches]
    return logits, {"decoder": _stack(layers)}


# ---------------------------------------------------------------------------
# A grid of ranks: tensor parallelism over 'model', FSDP over 'data'
# ---------------------------------------------------------------------------
# The reference's production layout (models.sharding's rule table on its
# mesh) for the attention families' forward (the dense decoder, the vlm --
# the decoder behind its patch prefix -- and the encoder-decoder) and the
# ssm family's:
# attention cut by heads / kv_heads, the MLP by its hidden columns (w1 /
# w3) and rows (w2), the embedding and the unembedding by vocab rows, each
# region entered by ``copy_to`` (identity, all-reduce of the gradient) and
# left by ``reduce_from`` (all-reduce, identity backward) over 'model'; a
# leaf whose dimension the guard dropped runs whole on every model rank
# with no collective.  The encoder's layers are the decoder's, bidirectional;
# a decoder layer's cross-attention takes its q heads from the layer's
# input and its k / v heads from the encoder's output (whole on every
# model rank, entering the regions once), one all-reduce after wo.  A
# mamba layer (the ssm family) cuts its d_inner, and its heads where they
# divide 'model', as the rule's ``"inner": ("model",)`` cuts them
# (``models.mamba2.grid_block_with_state``): B and C enter the region
# whole, the gated norm's sum of squares is all-reduced both ways, one
# all-reduce after ``out``.  Under FSDP (``cfg.fsdp``) the non-TP 'embed'
# dimension of every weight is cut over 'data' and gathered
# (``gather_from``: its gradient reduce-scattered) just before use.
#
# Serving runs the same layers.  Prefill is the forward on the rank's
# (pod, data) rows, keeping each layer's rope'd k and its v (and the cross
# k / v of the encoder's frames), and hands the decode step its cache in
# the decode step's layout (:func:`_grid_cache`: under ``cache_seq:
# ("model",)`` one all-to-all over 'model' turns the rank's kv heads at
# every position into every kv head at its positions; a cross cache whose
# frames do not divide 'model' is kept whole, never padded, and the decode
# step is told the frame count, ``enc_len``, to know which); the
# reference's prefill leaves that layout to GSPMD.  A decode step's
# attention (:func:`_grid_decode_attention`, the cross-attention's
# :func:`_grid_decode_cross`) is flash-decoding over the 'model' group on
# a position-cut cache (the rank's q heads, and the new k / v, gathered;
# one max and one sum all-reduce; one all-reduce after wo), or Megatron's
# on a head-cut or whole one (one all-reduce after wo).  The ssm family's
# cache is the rank's block of each layer's state (its heads of ``ssm``,
# its channels of ``conv_x``; no positions, so both layouts give one
# block), and a decode step's mamba layer takes two all-reduces (the
# norm, ``out``).  Tokens come from the vocab-cut logits by one
# all-gather (:meth:`GridLayout.greedy`, :meth:`GridLayout.whole_vocab`).

GRID_QUEUE = "ROADMAP.md queue 1, 'The grid'"
GRID_FAMILIES = ("dense", "vlm", "audio", "ssm")


def check_grid_family(cfg, grid) -> None:
    """Raise unless ``cfg`` trains and serves on ``grid``: any family but
    MoE on a grid whose 'model' axis is one rank (data parallelism: the
    train step's ZeRO-1, the engine's rows of slots), the attention
    families (dense, vlm, audio) and the ssm family alone where 'model' >
    1 or FSDP cuts the weights.  Nothing is replicated in place of a
    layout not ported."""
    if cfg.moe:
        raise ValueError(
            f"{cfg.name}: MoE experts over 'model' on a grid are not ported "
            f"({GRID_QUEUE}); experts sharded over a 1-D world of ranks "
            "train through train.elastic.run_data_parallel and serve through "
            "Engine(..., comm=), without a grid")
    tp = grid.get("model", 1) > 1 or (cfg.fsdp and grid.get("data", 1) > 1)
    if tp and cfg.family not in GRID_FAMILIES:
        raise ValueError(
            f"{cfg.name} ({cfg.family}): tensor parallelism / FSDP on a grid "
            f"trains and serves the {', '.join(GRID_FAMILIES)} families only "
            f"(the hybrid's MoE and mamba layers together: {GRID_QUEUE}); "
            f"this grid is {grid}")


def grid_layout(cfg, comm) -> "GridLayout | None":
    """The rank's :class:`GridLayout` on ``comm``'s grid (a
    ``core.world.GridComm``), or ``None`` where the model runs as on one
    rank (a 'model' axis of one rank, no FSDP cut): the grid is then
    data-parallel (ZeRO-1 alone, ``optim.adamw``; the engine's rows)."""
    check_grid_family(cfg, comm.grid)
    layout = GridLayout(cfg, comm)
    return layout if layout.model is not None or layout.fsdp else None


def grid_model(cfg, params: dict, comm, device=None) -> _LM:
    """The model of the rank at ``comm``'s coordinates (a
    ``core.world.GridComm``) from the whole parameter tree ``params``:
    each leaf's block by the rule table, copied onto ``device`` (default:
    ``comm.device``), the model built with the rank's layout
    (:func:`grid_layout`; raises for a family the grid does not run)."""
    layout = grid_layout(cfg, comm)
    specs = make_rules(comm.grid, fsdp=cfg.fsdp).tree(param_specs(cfg))
    return build_model(cfg, cut_tree(params, specs, comm.grid, comm.coords,
                                     device=device or comm.device), layout)


def _data_dim(spec: tuple, skip: int = 0) -> int | None:
    """The dimension of a spec cut over 'data' (less ``skip`` leading
    dimensions), or ``None``."""
    for i, e in enumerate(spec):
        if "data" in entry_axes(e):
            return i - skip
    return None


class GridLayout:
    """A rank's part of a model on a grid (``comm``: its
    ``core.world.GridComm``): which leaves the rule table cut over 'model'
    (``tp_heads``, ``tp_kv``, ``tp_mlp``, ``tp_vocab``; every attention of
    a layer -- the encoder's, the decoder's self and cross -- has one
    spec, and so has every MLP; mamba's ``tp_inner``, its d_inner, and
    ``tp_ssm_heads``, its heads; a flag of a sublayer the model lacks is
    false) and over 'data' (FSDP), the 'model' and 'data' groups, and the
    layers' functions."""

    def __init__(self, cfg, comm):
        grid = comm.grid
        rules = make_rules(grid, fsdp=cfg.fsdp)
        self.grid = grid
        self.specs = rules.tree(param_specs(cfg))
        self.model = comm.model
        self.data = comm.data
        self.rank = comm.coords["model"]
        stacks = ([self.specs["encoder"], self.specs["decoder"]]
                  if cfg.family == "audio" else
                  list(self.specs["blocks"].values()))
        kinds = {k: v for stack in stacks for k, v in stack.items()}
        M = grid["model"]

        def cut(kind, leaf, dim):        # dim counts the layer axis
            return (M > 1 and kind in kinds
                    and kinds[kind][leaf][dim] == "model")
        self.group = (cfg.resolved_q_heads // cfg.n_kv_heads
                      if "attn" in kinds else None)
        self.tp_heads = cut("attn", "wq", 2)
        self.tp_kv = cut("attn", "wk", 2)
        self.tp_mlp = cut("mlp", "w1", 2)
        self.tp_inner = cut("mamba", "wz", 2)
        self.tp_ssm_heads = cut("mamba", "A_log", 1)
        self.tp_vocab = M > 1 and self.specs["embedding"][0] == "model"
        # (sublayer, leaf) -> the layer tensor's dim cut over 'data'
        self.layer_dims = {}
        for stack in stacks:
            for k, v in stack.items():
                for n, spec in (v.items() if isinstance(v, dict) else
                                [(None, v)]):
                    self.layer_dims[(k, n)] = _data_dim(spec, skip=1)
        self.top_dims = {k: _data_dim(v) for k, v in self.specs.items()
                         if not isinstance(v, dict)}
        self.fsdp = self.data is not None and any(
            d is not None for d in list(self.layer_dims.values())
            + list(self.top_dims.values()))

    def _gather(self, t, dim):
        if not self.fsdp or dim is None:
            return t
        return gather_from(t, self.data, dim)

    def layer_tree(self, layer) -> dict:
        """The layer's parameters, each gathered whole over 'data' where
        FSDP cuts it."""
        out = {}
        for k, v in layer.tree(lambda p: p).items():
            out[k] = ({n: self._gather(t, self.layer_dims[(k, n)])
                       for n, t in v.items()} if isinstance(v, dict)
                      else self._gather(v, self.layer_dims[(k, None)]))
        return out

    def top_tree(self, model) -> dict:
        """The unstacked leaves (embedding, final norm, lm_head, the
        encoder's enc_norm), gathered once a forward where FSDP cuts
        them."""
        return {k: self._gather(v, self.top_dims[k])
                for k, v in model.top.items()}

    def embed(self, top, tokens):
        """Vocab-parallel lookup: a token outside the rank's rows gives
        zeros; the sum over 'model' is the row (exact: one term is not
        zero)."""
        emb = top["embedding"]
        if not self.tp_vocab:
            return emb[tokens]
        V = emb.shape[0]
        local = tokens - self.rank * V
        inside = (local >= 0) & (local < V)
        x = emb[local.clamp(0, V - 1)]
        return reduce_from(torch.where(inside[..., None], x, 0), self.model)

    def unembed(self, top, x):
        """The logits of the rank's vocab columns (all of them where the
        vocab is not cut)."""
        if self.tp_vocab:
            x = copy_to(x, self.model)
        if "lm_head" in top:
            return x @ top["lm_head"]
        return x @ top["embedding"].T

    def nll(self, logits, labels):
        """Vocab-parallel cross entropy on the rank's columns (B, S, V / M)
        of the padded vocab: logsumexp from the max all-reduce and a sum
        all-reduce, the gold logit summed from its owner."""
        m = self.model
        V = logits.shape[-1]
        with torch.no_grad():
            gmax = m.all_reduce(logits.amax(dim=-1).contiguous(), op="max")
        sumexp = reduce_from(torch.exp(logits - gmax[..., None]).sum(-1), m)
        local = labels - self.rank * V
        inside = (local >= 0) & (local < V)
        gold = torch.take_along_dim(logits, local.clamp(0, V - 1)[..., None],
                                    dim=-1)[..., 0]
        gold = reduce_from(torch.where(inside, gold, 0), m)
        return torch.log(sumexp) + gmax - gold

    def greedy(self, logits, vocab: int) -> torch.Tensor:
        """``torch.argmax`` over the unpadded vocabulary of the whole rows
        whose vocab columns the ranks hold (``logits`` (B, V / M)): each
        rank's (max, first index at it) over its columns -- the padded
        columns, which lie in the last rank's block, masked -- one
        all-gather of those (B, 2) pairs over 'model' (exact in f64), then
        the highest max and the lowest index at it, argmax's first-index
        rule.  Every model rank returns the same tokens (B,)."""
        if not self.tp_vocab:
            return torch.argmax(logits[:, :vocab], dim=-1)
        V = logits.shape[-1]
        col = self.rank * V + torch.arange(V, device=logits.device)
        masked = logits.masked_fill(col >= vocab, -math.inf)
        idx = torch.argmax(masked, dim=-1)
        best = torch.take_along_dim(masked, idx[:, None], dim=-1)[:, 0]
        pairs = torch.stack([best.double(), (idx + self.rank * V).double()],
                            dim=-1)
        allp = self.model.all_gather(pairs)                 # (M, B, 2)
        top = allp[..., 0].amax(dim=0)
        at = torch.where(allp[..., 0] == top, allp[..., 1], math.inf)
        return at.amin(dim=0).long()

    def whole_vocab(self, logits):
        """The whole rows (B, Vpad) of the ranks' vocab columns: one
        all-gather over 'model' (the same bits on every model rank)."""
        return torch.cat(self.model.all_gather(logits.contiguous()).unbind(0),
                         dim=-1)


def _grid_attention(p, h, cfg, positions, lay: GridLayout, kv=None,
                    causal: bool = True):
    """Self-attention of the rank's q heads ``[r H / M, (r + 1) H / M)``,
    one all-reduce over 'model' after ``wo``.  Where the kv heads are not
    cut (the guard dropped them), every rank computes all of them and each
    of its q heads h takes kv head h // G (the reference's grouping), and
    the whole wk / wv take their gradient summed over the ranks.  Where
    the q heads are not cut, attention runs whole on every rank.  ``kv``:
    a list that takes the rope'd k and the v of the kv heads the rank
    holds (prefill's cache).  ``causal=False``: the encoder's."""
    m = lay.model
    if not lay.tp_heads:
        q, k, v = _project(p, h, cfg, positions)
        out = L.out_proj(p, _attend(q, k, v, cfg, causal))
    else:
        h = copy_to(h, m)
        if lay.tp_kv:
            q, k, v = _project(p, h, cfg, positions)
            kk, vv = k, v
        else:
            p = _whole_kv_weights(p, m)
            q, k, v = L.qkv_proj(p, h)
            q = L.rope(q, positions, cfg.rope_theta)
            k = L.rope(k, positions, cfg.rope_theta)
            kk, vv = _kv_of_rank(k, lay, q.shape[2]), _kv_of_rank(
                v, lay, q.shape[2])
        out = reduce_from(L.out_proj(p, _attend(q, kk, vv, cfg, causal)), m)
    if kv is not None:
        kv.append({"k": k, "v": v})
    return out


def _whole_kv_weights(p, m) -> dict:
    """The attention leaves with wk / wv (and their biases) entering the
    region by ``copy_to``: whole on every rank, their gradient summed."""
    return {n: copy_to(t, m) if n in ("wk", "wv", "bk", "bv") else t
            for n, t in p.items()}


def _grid_cross_attention(p, h, enc, cfg, lay: GridLayout, kv=None):
    """Cross-attention of the rank's q heads (from the decoder's ``h``) to
    the encoder's output ``enc`` (whole on every model rank; it entered
    the region in :func:`_cross_decoder_stack`), no rope, every frame
    seen, one all-reduce over 'model' after ``wo``; kv heads as in
    :func:`_grid_attention` (h // G's where the guard keeps them whole).
    ``kv``: a list that takes the cross k / v of the kv heads the rank
    holds (prefill's cache)."""
    m = lay.model
    if not lay.tp_heads:
        q, k, v = L.qkv_proj(p, h, enc)
        out = L.out_proj(p, _attend(q, k, v, cfg, causal=False))
    else:
        h = copy_to(h, m)
        if not lay.tp_kv:
            p = _whole_kv_weights(p, m)
        q, k, v = L.qkv_proj(p, h, enc)
        kk, vv = ((k, v) if lay.tp_kv else
                  (_kv_of_rank(k, lay, q.shape[2]),
                   _kv_of_rank(v, lay, q.shape[2])))
        out = reduce_from(L.out_proj(p, _attend(q, kk, vv, cfg,
                                                causal=False)), m)
    if kv is not None:
        kv.append({"xk": k, "xv": v})
    return out


def _kv_of_rank(t, lay: GridLayout, heads: int):
    """The kv head of each of the rank's ``heads`` q heads (h // G of the
    global q head h), from every kv head (dim 2): a copy."""
    at = (lay.rank * heads + torch.arange(heads, device=t.device)) \
        // lay.group
    return t.index_select(2, at)


def _grid_mlp(p, h, lay: GridLayout):
    """SwiGLU with w1 / w3 cut by columns and w2 by rows over 'model', one
    all-reduce; whole on every rank where the guard dropped d_ff."""
    if not lay.tp_mlp:
        return L.swiglu(p, h)
    return reduce_from(L.swiglu(p, copy_to(h, lay.model)), lay.model)


def _grid_mamba(p, h, cfg, lay: GridLayout):
    """The mamba block of a rank on a grid: its d_inner (and heads) over
    'model' (``models.mamba2.grid_block_with_state``), or whole on every
    rank where the guard dropped d_inner (no collective).  Returns (out,
    the rank's block of the layer's decode state)."""
    if not lay.tp_inner:
        return M.mamba_block_with_state(p, h, cfg)
    return M.grid_block_with_state(p, h, cfg, lay.model, lay.rank,
                                   lay.tp_ssm_heads)


def _grid_layer(p: dict, x, cfg, positions, lay: GridLayout, caches=None):
    """One decoder layer on a grid, attention or mamba, then the MLP where
    it has one (``p``: its parameters, gathered under FSDP); appends the
    layer's k / v or mamba state to ``caches`` when given."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if "attn" in p:
        x = x + _grid_attention(p["attn"], h, cfg, positions, lay, caches)
    else:
        out, state = _grid_mamba(p["mamba"], h, cfg, lay)
        x = x + out
        if caches is not None:
            caches.append(state)
    if "mlp" not in p:
        return x
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + _grid_mlp(p["mlp"], h, lay)


def _grid_encoder_layer(p: dict, x, cfg, positions, lay: GridLayout):
    """One encoder layer on a grid: bidirectional attention, the MLP."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + _grid_attention(p["attn"], h, cfg, positions, lay, causal=False)
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + _grid_mlp(p["mlp"], h, lay)


def _grid_cross_layer(p: dict, x, cfg, positions, enc, lay: GridLayout,
                      caches=None):
    """One decoder layer of the enc-dec body on a grid: causal
    self-attention, cross-attention to ``enc``, the MLP; appends the
    layer's k / v and cross xk / xv to ``caches`` when given."""
    kv = None if caches is None else []
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + _grid_attention(p["attn"], h, cfg, positions, lay, kv)
    h = L.rmsnorm(x, p["lnx"], cfg.norm_eps)
    x = x + _grid_cross_attention(p["cross"], h, enc, cfg, lay, kv)
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    x = x + _grid_mlp(p["mlp"], h, lay)
    if caches is not None:
        caches.append({**kv[0], **kv[1]})
    return x


# ------------------------------------------------------- serving on a grid --

def _seq_cut(lay: GridLayout, seq_shard: bool) -> bool:
    """Is the cache's position axis cut over 'model' (``cache_seq``)?"""
    return seq_shard and lay.model is not None


def _cross_cut(lay: GridLayout, seq_shard: bool, frames: int,
               held: int | None = None) -> bool:
    """Are a cross cache's ``frames`` (the encoder's) cut over 'model'
    (:func:`cache_shardings`)?  Under ``cache_seq`` on 'model' > 1 where
    they divide the group, else whole on every rank: a cross cache is
    never padded, since the decode step attends every cached frame.  A
    rank's block alone cannot tell a cut cache from a whole one (F / M
    frames of a cut one may be F' whole ones), so the decode step is told
    ``frames`` and checks the rank's ``held`` frames against them."""
    cut = _seq_cut(lay, seq_shard) and frames % lay.model.size == 0
    if held is not None and held != (frames // lay.model.size if cut
                                     else frames):
        raise ValueError(
            f"a cross cache block of {held} frames on this rank of a grid, "
            f"for an encoder of {frames} frames (enc_len): the cache's "
            f"frames are cut over 'model' only under cache_seq where they "
            f"divide it, else whole")
    return cut


def _to_positions(t, M: int):
    """(two, n, B, S, h, Dh) as M rows for an all-to-all over 'model': row
    q holds positions ``[q S / M, (q + 1) S / M)``."""
    two, n, B, S, h, Dh = t.shape
    return t.reshape(two, n, B, M, S // M, h, Dh).movedim(3, 0).reshape(
        M, -1)


def _from_heads(rows, shape: tuple, M: int):
    """The all-to-all's M rows (rank q's kv heads at this rank's
    positions, ``shape`` (two, n, B, S / M, h, Dh) each) as every kv head
    at those positions, in the global head order."""
    two, n, B, Sl, h, Dh = shape
    return rows.reshape(M, two, n, B, Sl, h, Dh).permute(
        1, 2, 3, 4, 0, 5, 6).reshape(two, n, B, Sl, M * h, Dh)


def _grid_cache(caches: list, cfg, lay: GridLayout, max_seq: int,
                seq_shard: bool) -> dict:
    """Prefill's per-layer k / v (B, S, heads the rank holds, Dh) as the
    decode step's cache block (:func:`cache_shardings`), zero-padded to
    ``max_seq`` (the padding lands on the shard that owns those
    positions).  Under ``cache_seq`` the rank keeps its S / M positions of
    every kv head: where the ranks hold their kv heads, one all-to-all over
    'model' of every layer's k and v at once (each rank sends rank q its
    heads at q's positions); where each holds all of them, a slice.  The
    audio family's cross xk / xv stay at the encoder's length, never
    padded: under ``cache_seq`` their frames go with the same all-to-all
    (or slice) where they divide 'model', and are otherwise whole, every
    kv head on every rank (one all-gather of the rank's heads where it
    holds its own); on a head-cut cache they keep the rank's kv heads.
    The ssm family's per-layer states are the rank's blocks already (no
    positions: both layouts give the same block), stacked as they are."""
    period = _superblock_period(cfg)
    if "ssm" in caches[0]:
        return {"blocks": {f"sub{j}": {
            n: torch.stack([c[n] for c in caches[j::period]]).to(
                torch.float32 if n == "ssm" else cfg.dtype).contiguous()
            for n in caches[0]} for j in range(period)}}
    k = torch.stack([c["k"] for c in caches])      # (layers, B, S, h, Dh)
    v = torch.stack([c["v"] for c in caches])
    S = k.shape[2]
    if max_seq < S:
        raise ValueError(f"max_seq={max_seq} is shorter than the prompt "
                         f"({S} positions)")
    kv = torch.nn.functional.pad(torch.stack([k, v]),
                                 (0, 0, 0, 0, 0, max_seq - S)).to(cfg.dtype)
    xkv, cut = None, False
    if cfg.family == "audio":
        xkv = torch.stack([torch.stack([c[n] for c in caches])
                           for n in ("xk", "xv")]).to(cfg.dtype)
        cut = _cross_cut(lay, seq_shard, xkv.shape[3])
    if _seq_cut(lay, seq_shard):
        M, r = lay.model.size, lay.rank
        Sl = _shard_len(max_seq, M)
        if kv.shape[4] < cfg.n_kv_heads:            # the rank's kv heads
            parts = [kv] + ([xkv] if cut else [])
            rows = lay.model.all_to_all(
                torch.cat([_to_positions(t, M) for t in parts], dim=1),
                [1] * M, [1] * M)
            out, at = [], 0
            for t in parts:
                n = t.numel() // M
                shape = t.shape[:3] + (t.shape[3] // M,) + t.shape[4:]
                out.append(_from_heads(rows[:, at:at + n], shape, M))
                at += n
            kv = out[0]
            if cut:
                xkv = out[1]
            elif xkv is not None:               # whole: every kv head
                xkv = lay.model.all_gather(xkv.contiguous()).permute(
                    1, 2, 3, 4, 0, 5, 6).reshape(
                    xkv.shape[:4] + (M * xkv.shape[4], xkv.shape[5]))
        else:
            kv = kv[:, :, :, r * Sl:(r + 1) * Sl]
            if cut:
                Fl = xkv.shape[3] // M
                xkv = xkv[:, :, :, r * Fl:(r + 1) * Fl]
    if xkv is not None:
        return {"decoder": {"k": kv[0].contiguous(), "v": kv[1].contiguous(),
                            "xk": xkv[0].contiguous(),
                            "xv": xkv[1].contiguous()}}
    return {"blocks": {f"sub{j}": {"k": kv[0, j::period].contiguous(),
                                   "v": kv[1, j::period].contiguous()}
                       for j in range(period)}}


def _grid_prefill(model, cfg, batch: dict, max_seq, seq_shard: bool):
    """:func:`prefill` of a rank's model on a grid: the tensor-parallel
    forward on the rank's rows (the audio family's encoder on its rows of
    ``src_embeds`` first), the last position's logits of the rank's vocab
    columns, the cache block of :func:`_grid_cache`."""
    lay = model.layout
    check_grid_family(cfg, lay.grid)
    top = lay.top_tree(model)
    x = _embed(model, cfg, batch, top)
    S = x.shape[1]
    caches: list = []
    if cfg.family == "audio":
        enc = _encoder_stack(model, cfg, batch["src_embeds"], top)
        x, _ = _cross_decoder_stack(model, cfg, x, enc, caches)
    else:
        x, _ = _decoder_stack(model, cfg, x, _positions(S, x.device), caches)
    x = L.rmsnorm(x[:, -1:, :], top["final_norm"], cfg.norm_eps)
    logits = lay.unembed(top, x)[:, 0, :]
    return logits, _grid_cache(caches, cfg, lay, max_seq or S, seq_shard)


def _gather_heads(parts: list, m) -> list:
    """Each (B, 1, h, Dh) of ``parts`` with the heads of every rank of the
    'model' group, in rank order (the global head order): one all-gather
    of them packed."""
    B = parts[0].shape[0]
    flat = torch.cat([t.reshape(B, -1) for t in parts], dim=1)
    allp = m.all_gather(flat)                       # (M, B, n)
    out, at = [], 0
    for t in parts:
        n = t[0].numel()
        h, Dh = t.shape[2], t.shape[3]
        out.append(allp[:, :, at:at + n].reshape(m.size, B, h, Dh)
                   .permute(1, 0, 2, 3).reshape(B, 1, m.size * h, Dh))
        at += n
    return out


def _grid_decode_attention(p, c, h, cfg, pos, rows, lay: GridLayout,
                           seq_shard: bool):
    """A decode step's self-attention on a rank of a grid; ``c`` the
    layer's cache block.  Position-cut cache (``cache_seq`` over 'model'):
    the rank's q heads, and its new k / v where wk / wv are cut, gathered
    over 'model' (one all-gather); the new row written, every kv head, only
    on the rank that owns ``pos`` (elsewhere the slot it would clamp to is
    rewritten with its own bytes: no host wait); flash-decoding of every
    head over the group (``layers.decode_attention_seqsharded``: one max
    and one sum all-reduce); the rank's heads kept for its rows of wo, one
    all-reduce.  Head-cut cache (``seq_shard=False``, Megatron's): the
    rank's q heads against the kv heads it holds (h // G's where the guard
    kept them whole), one all-reduce after wo.  Where the q heads are not
    cut, every rank computes every head (flash-decoding still runs over
    the group on a position-cut cache) and no all-reduce follows wo."""
    m = lay.model
    q, k, v = L.qkv_proj(p, h)
    q = L.rope(q, pos[:, None], cfg.rope_theta)
    k = L.rope(k, pos[:, None], cfg.rope_theta)
    Hl = q.shape[2]
    if _seq_cut(lay, seq_shard):
        if c["k"].shape[2] != cfg.n_kv_heads:
            raise ValueError("decode_step(seq_shard=True) needs a cache "
                             "whose positions are cut over 'model' "
                             "(init_cache / prefill with seq_shard=True)")
        if lay.tp_heads and lay.tp_kv:
            q, k, v = _gather_heads([q, k, v], m)
        elif lay.tp_heads:
            q, = _gather_heads([q], m)
        S_local = c["k"].shape[1]
        lo = lay.rank * S_local
        own = ((pos >= lo) & (pos < lo + S_local))[:, None, None]
        at = (pos - lo).clamp(0, S_local - 1)
        for name, new in (("k", k), ("v", v)):
            leaf = c[name]
            leaf[rows, at] = torch.where(own, new[:, 0].to(leaf.dtype),
                                         leaf[rows, at])
        out = L.decode_attention_seqsharded(q, c["k"], c["v"], pos, comm=m)
        if lay.tp_heads:
            out = out[:, :, lay.rank * Hl:(lay.rank + 1) * Hl]
    else:
        if c["k"].shape[2] != k.shape[2]:
            raise ValueError("decode_step(seq_shard=False) needs a cache "
                             "whose kv heads are cut as wk's "
                             "(init_cache / prefill with seq_shard=False)")
        c["k"][rows, pos] = k[:, 0].to(c["k"].dtype)
        c["v"][rows, pos] = v[:, 0].to(c["v"].dtype)
        ck, cv = c["k"], c["v"]
        if lay.tp_heads and not lay.tp_kv:
            ck, cv = _kv_of_rank(ck, lay, Hl), _kv_of_rank(cv, lay, Hl)
        out = L.decode_attention(q, ck, cv, pos)
    out = L.out_proj(p, out)
    return reduce_from(out, m) if lay.tp_heads else out


def _grid_decode_cross(p, c, h, cfg, lay: GridLayout, seq_shard: bool,
                       enc_len: int | None):
    """A decode step's cross-attention on a rank of a grid; ``c`` the
    layer's cache block of an encoder of ``enc_len`` frames (needed only
    where the cache's positions are cut over 'model'), every cached frame
    attended (the reference's decode attends at enc_len - 1).  Frames cut
    over 'model' (:func:`_cross_cut`): the rank's q heads gathered over
    'model' (one
    all-gather), flash-decoding of every head over the group with no frame
    masked (``layers.decode_attention_seqsharded``: one max and one sum
    all-reduce), the rank's heads kept for its rows of wo, one all-reduce.
    A head-cut or whole cross cache: the rank's q heads against the kv
    heads it holds (h // G's of a whole one), one all-reduce after wo.
    Where the q heads are not cut, every rank computes every head and no
    all-reduce follows wo."""
    m = lay.model
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    Hl = q.shape[2]
    xk, xv = c["xk"], c["xv"]
    cut = False
    if _seq_cut(lay, seq_shard):
        if enc_len is None:
            raise ValueError(
                "decode_step of the audio family on a grid with the cache's "
                "positions over 'model' needs enc_len (the encoder's frame "
                "count, prefill's src_embeds length): a rank's cross cache "
                "block does not say whether its frames were cut")
        cut = _cross_cut(lay, seq_shard, enc_len, held=xk.shape[1])
    if cut:
        if lay.tp_heads:
            q, = _gather_heads([q], m)
        out = L.decode_attention_seqsharded(q, xk, xv,
                                            xk.shape[1] * m.size - 1, comm=m)
        if lay.tp_heads:
            out = out[:, :, lay.rank * Hl:(lay.rank + 1) * Hl]
    else:
        if lay.tp_heads and xk.shape[2] == cfg.n_kv_heads:
            xk, xv = _kv_of_rank(xk, lay, Hl), _kv_of_rank(xv, lay, Hl)
        out = L.decode_attention(q, xk, xv, xk.shape[1] - 1)
    out = L.out_proj(p, out)
    return reduce_from(out, m) if lay.tp_heads else out


def _grid_decode_mamba(p, c, h, cfg, lay: GridLayout):
    """A decode step's mamba block on a rank of a grid: ``c`` the layer's
    state block, updated in place (``models.mamba2.grid_decode_step``: one
    all-reduce for the norm, one after ``out``; whole on every rank, no
    collective, where the guard dropped d_inner)."""
    if lay.tp_inner:
        out, state = M.grid_decode_step(p, c, h[:, 0], cfg, lay.model,
                                        lay.rank, lay.tp_ssm_heads)
    else:
        out, state = M.mamba_decode_step(p, c, h[:, 0], cfg)
    for name, leaf in state.items():
        c[name].copy_(leaf)
    return out[:, None, :]


def _grid_decode_step(model, cfg, cache: dict, token, pos, seq_shard: bool,
                      enc_len: int | None = None):
    """:func:`decode_step` of a rank's model on a grid: the token in by the
    vocab-parallel lookup (one all-reduce), each layer's weights gathered
    under FSDP, :func:`_grid_decode_attention` (and the enc-dec body's
    :func:`_grid_decode_cross`) and the tensor-parallel MLP (one
    all-reduce), or :func:`_grid_decode_mamba`, the logits of the rank's
    vocab columns."""
    lay = model.layout
    check_grid_family(cfg, lay.grid)
    dev = model.device
    token = torch.as_tensor(token, device=dev).long()
    pos = torch.as_tensor(pos, device=dev).long()
    rows = torch.arange(token.shape[0], device=dev)
    top = lay.top_tree(model)
    x = lay.embed(top, token[:, None]).to(cfg.dtype)         # (B, 1, D)
    layers = model.dec_layers if cfg.family == "audio" else model.layers
    for i, layer in enumerate(layers):
        p = lay.layer_tree(layer)
        c = _layer_cache(cache, cfg, i)
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        if "mamba" in p:
            x = x + _grid_decode_mamba(p["mamba"], c, h, cfg, lay)
        else:
            x = x + _grid_decode_attention(p["attn"], c, h, cfg, pos, rows,
                                           lay, seq_shard)
        if "cross" in p:
            h = L.rmsnorm(x, p["lnx"], cfg.norm_eps)
            x = x + _grid_decode_cross(p["cross"], c, h, cfg, lay, seq_shard,
                                       enc_len)
        if "mlp" in p:
            h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
            x = x + _grid_mlp(p["mlp"], h, lay)
    x = L.rmsnorm(x, top["final_norm"], cfg.norm_eps)
    return lay.unembed(top, x)[:, 0, :], cache
