"""The operands of every (architecture x shape) dry-run cell, the twin of
``repro.launch.inputs``.

The reference returns ``ShapeDtypeStruct`` stand-ins with mesh shardings;
the port's counterpart of a shape-and-dtype stand-in is a tensor on
``torch.device("meta")``: never allocated, so the bytes of a production
cell (hundreds of GB for a decode cache) are summed without a byte of
memory.  The port has no mesh, so the specs are one rank's of a world of
P ranks (``core.world.SolverWorld``), as its parallelism cuts them:

* train and prefill are data-parallel: a rank takes its B / P rows of the
  global batch, as ``train.trainer`` cuts them, and holds the whole
  parameters (and train state);
* decode takes the whole batch, with every self-attention k / v cut over
  the sequence into P shards when ``seq_shard`` is set (flash-decoding,
  ``models.api.decode_step(..., comm=...)``), whole otherwise;
* an MoE model's experts are sharded over the P ranks in every kind
  (``models.moe``): a rank's parameters and train state hold E / P
  experts of every MoE layer (:func:`expert_shard`).

On a grid of ranks (``grid``: the reference's ``16x16`` / ``2x16x16``
meshes, ``launch.mesh``, or any ``{"pod", "data", "model"}``) a rank's
specs are its blocks under the rule table (``models.sharding``), every
kind as the reference's ``inputs`` shards it: the train state by
``train.trainer.abstract_train_state`` (parameters under ``cfg.fsdp``,
the optimizer ZeRO-1), the batch's rows over (pod, data), prefill's
parameters, and decode's parameters and cache under the rules with the
``cache_seq: ("model",)`` override when ``seq_shard`` is set
(``models.api.cache_rules``, the rules the grid's decode step runs on).

The audio family's ``src_embeds`` (max(S / 4, 128) encoder frames) and the
vlm family's ``extra_embeds`` (the patch prefix) take the reference's
shapes.  :func:`materialize` turns a spec tree into tensors on a device
from a ``torch.Generator``, so that the dry run's probe runs on operands
from these same functions.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import api
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.models.sharding import make_rules, shard_shape
from repro_torch.train.trainer import abstract_train_state, train_state_specs

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _from_specs(specs) -> dict:
    return tree_map(lambda s: _meta(s.shape, s.dtype), specs)


def rank_rows(global_batch: int, n_ranks: int) -> int:
    """A data-parallel rank's rows of the global batch."""
    if n_ranks < 1 or global_batch % n_ranks:
        raise ValueError(f"a global batch of {global_batch} rows does not "
                         f"split over {n_ranks} ranks")
    return global_batch // n_ranks


# The logical axes of a batch's leaves (the reference's specs of them).
BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
              "mask": ("batch", "seq"),
              "src_embeds": ("batch", "seq", "embed"),
              "extra_embeds": ("batch", "seq", "embed")}


def _grid_cut(specs, rules) -> dict:
    """Meta blocks of a ParamSpec tree under ``rules``."""
    return tree_map(lambda s: _meta(shard_shape(s.shape, rules.spec_of(s),
                                                rules.grid), s.dtype), specs)


def _cut_batch(batch: dict, rules) -> dict:
    return {k: _meta(shard_shape(t.shape, rules.spec_for(
        tuple(t.shape), BATCH_AXES[k]), rules.grid), t.dtype)
        for k, t in batch.items()}


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, n_ranks: int = 1,
                rows: int | None = None, *, grid=None) -> dict:
    """A rank's training / prefill batch (``rows`` overrides its B / P);
    on ``grid`` its block of the global batch."""
    if grid is not None:
        return _cut_batch(batch_specs(cfg, shape, rows=shape.global_batch),
                          make_rules(grid, fsdp=cfg.fsdp))
    B = rank_rows(shape.global_batch, n_ranks) if rows is None else rows
    S = shape.seq_len
    out = {}
    if cfg.family == "audio":
        out["src_embeds"] = _meta((B, max(S // 4, 128), cfg.d_model),
                                  cfg.dtype)
        out["tokens"] = _meta((B, S), torch.int32)
    elif cfg.family == "vlm":
        ft = cfg.frontend_tokens
        out["extra_embeds"] = _meta((B, ft, cfg.d_model), cfg.dtype)
        out["tokens"] = _meta((B, S - ft), torch.int32)
    else:
        out["tokens"] = _meta((B, S), torch.int32)
    if shape.kind == "train":
        lab = tuple(out["tokens"].shape)
        out["labels"] = _meta(lab, torch.int32)
        out["mask"] = _meta(lab, torch.float32)
    return out


def expert_shard(cfg: ModelConfig, n_ranks: int) -> tuple | None:
    """The cut of a rank's experts, ``(0, P)`` (every rank's shard has
    the same shapes), for an MoE model on P > 1 ranks; ``None``
    otherwise.  Raises where E % P != 0."""
    return (0, n_ranks) if cfg.moe and n_ranks > 1 else None


def _params(cfg: ModelConfig, n_ranks: int) -> dict:
    return _from_specs(api.param_specs(
        cfg, expert_shard=expert_shard(cfg, n_ranks)))


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, n_ranks: int = 1, *,
                 seq_shard: bool = True, rows: int | None = None,
                 grid=None) -> tuple:
    """(params, cache, token, pos) of a rank's decode step: the whole batch
    (``rows`` overrides it), the cache's sequence cut over the ranks when
    ``seq_shard``; on ``grid`` the rank's blocks, the cache's sequence
    over 'model' when ``seq_shard`` (the reference's override)."""
    B = shape.global_batch if rows is None else rows
    if grid is not None:
        rules = api.cache_rules(cfg, grid, seq_shard)
        tok = _meta(shard_shape((B,), rules.spec_for((B,), ("batch",)),
                                rules.grid), torch.int32)
        return (_grid_cut(api.param_specs(cfg), rules),
                _grid_cut(api.init_cache_specs(cfg, B, shape.seq_len), rules),
                tok, tok.clone())
    shards = n_ranks if seq_shard else 1
    params = _params(cfg, n_ranks)
    cache = _from_specs(api.init_cache_specs(cfg, B, shape.seq_len, shards))
    return params, cache, _meta((B,), torch.int32), _meta((B,), torch.int32)


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig, n_ranks: int = 1,
                  rows: int | None = None, *, grid=None) -> tuple:
    """(params, batch) of a rank's prefill (its blocks on ``grid``)."""
    if grid is not None:
        return (_grid_cut(api.param_specs(cfg),
                          make_rules(grid, fsdp=cfg.fsdp)),
                batch_specs(cfg, shape, grid=grid))
    return _params(cfg, n_ranks), batch_specs(cfg, shape, n_ranks, rows)


def train_specs(cfg: ModelConfig, shape: ShapeConfig, n_ranks: int = 1,
                rows: int | None = None, *, grid=None) -> tuple:
    """(state, batch) of a rank's train step: the whole (replicated) state
    but the rank's shard of an MoE model's experts, and the rank's rows;
    on ``grid`` the rank's blocks of both."""
    if grid is not None:
        return (abstract_train_state(cfg, grid),
                batch_specs(cfg, shape, grid=grid))
    return (_from_specs(train_state_specs(cfg, expert_shard(cfg, n_ranks))),
            batch_specs(cfg, shape, n_ranks, rows))


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a (meta or real) tree of dicts,
    tuples and lists."""
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(t) for t in tree)
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(tree, is_leaf=torch.is_tensor)
               if torch.is_tensor(t))


def materialize(tree, device, generator: torch.Generator, *,
                high: int = 2) -> dict:
    """Real tensors of a spec tree's shapes and dtypes on ``device``:
    floating leaves N(0, 0.02^2), integer leaves uniform in [0, ``high``)
    (token ids: pass the vocabulary), drawn from ``generator`` (on
    ``device``'s type) in the tree's sorted-key order."""
    def one(t):
        if not torch.is_tensor(t):
            return t
        if t.dtype.is_floating_point:
            x = torch.randn(t.shape, generator=generator, device=device,
                            dtype=torch.float32)
            return (x * 0.02).to(t.dtype)
        return torch.randint(0, high, t.shape, generator=generator,
                             device=device, dtype=t.dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return one(node)

    return walk(tree)
