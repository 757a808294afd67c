"""Carrying problems, plans and results between the reference package and
the port.

The two packages share no code and no random streams, so a comparison hands
both the same numpy arrays: :func:`problem_from_numpy` turns the reference's
arrays into the port's tensors in the same layouts, :func:`plan_from_reference`
maps the reference ``SolverPlan`` fields this port supports (a reference
``FaultPlan`` through :func:`fault_from_reference`), and
:func:`result_to_numpy` converts a port result back.  For the tenant-batched
engine, :func:`batch_from_numpy` builds a ``TenantBatch`` from numpy arrays
and :func:`batched_result_to_numpy` converts a batched result back.  For
the LM, :func:`lm_params_from_reference` builds the port's model (every
family: dense, vlm, ssm, hybrid, moe and the encoder-decoder) from the
reference's parameter tree, and :func:`lm_cache_from_reference` /
:func:`lm_cache_to_numpy` carry a decode cache across, the mamba state
included.  For training, :func:`train_state_from_reference` and
:func:`train_state_to_numpy` carry a train state (parameters, the f32
master, m and v, the step) both ways.  Each takes a rank's cut of experts
sharded over ranks (``expert_shard=(rank, P)`` in, ``comm`` out: the
gather gives back the reference's whole tree); :func:`join_expert_shards`
joins the ranks' shards without a world.  On a grid of ranks
(``models.sharding``) the two ``..._from_reference`` functions cut the
reference's tree into a rank's blocks by the rule table (``comm``: the
rank's ``core.world.GridComm`` for the model, whose layout it takes;
``grid`` / ``coords`` for a train state).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import (BatchedSolveResult, SolveResult,
                                     SolverPlan, TenantBatch)
from repro_torch.faults import FaultPlan

# Reference impls and their counterparts here: the jnp oracles map to the
# plain versions, the TPU kernels to the CUDA kernels.
_IMPL_MAP = {None: None, "ref": "ref", "pallas": "cuda"}


def problem_from_numpy(X, y, idx, x0=None, *, device, dtype):
    """(X (d, n), y (n,), idx int32 (iters, b), x0 or None) as tensors on
    ``device`` in ``dtype`` (idx stays int32)."""
    def conv(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    idx_t = torch.as_tensor(np.asarray(idx, dtype=np.int32), device=device)
    return conv(X), conv(y), idx_t, (None if x0 is None else conv(x0))


def fault_from_reference(fault) -> FaultPlan:
    """The port's :class:`~repro_torch.faults.FaultPlan` with the five fields
    (kind, step, shard, seed, survivors) of a reference ``FaultPlan``, read
    by name (or from the dict ``dataclasses.asdict`` makes of one).  Raises
    ``ValueError`` for an object that lacks one."""
    names = ("kind", "step", "shard", "seed", "survivors")
    values = (dict(fault) if isinstance(fault, dict) else
              {name: getattr(fault, name) for name in names
               if hasattr(fault, name)})
    missing = [name for name in names if name not in values]
    if missing:
        raise ValueError(f"fault {fault!r} is not supported: it has no "
                         f"{missing}")
    return FaultPlan(**{name: values[name] for name in names})


def plan_from_reference(**fields) -> SolverPlan:
    """A :class:`SolverPlan` from reference ``SolverPlan`` keyword fields.

    Supported: ``b``, ``s``, ``impl`` (``"ref"``, ``"pallas"`` -> ``"cuda"``,
    ``None``), ``track_cond``, ``tenants``, ``guard`` (a bool),
    ``guard_boost``, ``guard_cond_max``, ``fault`` (a reference
    ``FaultPlan``, converted by :func:`fault_from_reference`),
    ``fuse_packet`` and ``wire`` (``"psum"`` or ``"ring"``), and
    ``unroll``, which has no counterpart in a host loop and is dropped.
    Raises on what this port does not have: another ``wire``, TPU
    ``tiles``, and any other field.
    """
    fields = dict(fields)
    fields.pop("unroll", None)
    unsupported = []
    if not isinstance(fields.get("guard", False), bool):
        unsupported.append(f"guard={fields.pop('guard')!r}")
    if fields.get("fault") is not None:
        try:
            fields["fault"] = fault_from_reference(fields["fault"])
        except ValueError:
            unsupported.append(f"fault={fields.pop('fault')!r}")
    if fields.pop("tiles", None) is not None:
        unsupported.append("tiles")
    if fields.get("wire", "psum") not in ("psum", "ring"):
        unsupported.append(f"wire={fields.pop('wire')!r}")
    impl = fields.pop("impl", None)
    if impl not in _IMPL_MAP:
        unsupported.append(f"impl={impl!r}")
    unsupported.extend(sorted(set(fields) - {
        "b", "s", "track_cond", "tenants", "guard", "guard_boost",
        "guard_cond_max", "fault", "fuse_packet", "wire"}))
    if unsupported:
        raise ValueError(f"reference plan fields not supported by the port: "
                         f"{unsupported}")
    return SolverPlan(impl=_IMPL_MAP[impl], **fields)


def result_to_numpy(res: SolveResult) -> SolveResult:
    """The same result with every tensor copied to a numpy array."""
    def conv(t):
        return t.detach().cpu().numpy()
    return SolveResult(conv(res.w), conv(res.alpha),
                       {k: conv(v) for k, v in res.history.items()},
                       {k: conv(v) if isinstance(v, torch.Tensor) else v
                        for k, v in res.metrics.items()})


def batch_from_numpy(ys, lams, coeffs=None, x0s=None, tol=None, *, device,
                     dtype) -> TenantBatch:
    """A :class:`TenantBatch` from numpy: ys (T, n) and x0s (T, dim) as
    tensors on ``device`` in ``dtype``; lams and each coefficient (T,) as
    python floats."""
    def conv(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return TenantBatch(
        ys=conv(ys), lams=[float(v) for v in np.asarray(lams)],
        coeffs={k: [float(v) for v in np.asarray(c)]
                for k, c in (coeffs or {}).items()},
        x0s=None if x0s is None else conv(x0s), tol=tol)


def batched_result_to_numpy(res: BatchedSolveResult) -> BatchedSolveResult:
    """The same batched result with every tensor copied to a numpy array."""
    def conv(t):
        return t.detach().cpu().numpy()
    return BatchedSolveResult(conv(res.ws), conv(res.alphas),
                              conv(res.active),
                              {k: conv(v) for k, v in res.metrics.items()})


def _tree_to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device, dtype) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":          # numpy has no bf16 of its own
        a = a.astype(np.float32)
    t = torch.as_tensor(np.array(a), device=device)
    return t if dtype is None else t.to(dtype)


def lm_params_from_reference(params_np, cfg, *, device, dtype=None,
                             expert_shard: tuple | None = None, comm=None):
    """The port's model for ``cfg`` (``models.api.build_model``: a
    :class:`~repro_torch.models.DecoderLM`, or an
    :class:`~repro_torch.models.EncDecLM` for the audio family) with the
    reference's parameters: ``params_np`` is the reference's tree (numpy
    arrays, layer axes stacked under ``blocks/sub{j}`` or ``encoder`` /
    ``decoder``; mamba, MoE and cross-attention sublayers included), each
    leaf placed on ``device`` in the type its spec gives a model of
    ``dtype`` (default: ``cfg.param_dtype``; the f32 parameters -- mamba's
    ``A_log``, ``D``, ``dt_bias`` and the MoE router -- stay f32, as in the
    reference).  A bf16 leaf is carried through f32, which holds it
    exactly.  ``expert_shard=(rank, P)``: the model of rank ``rank`` of a
    world over which the experts are sharded (``models.moe``): every MoE
    leaf w1 / w3 / w2 cut to the rank's E / P experts before it is
    placed.  ``comm``: the model of the rank of a grid (a
    ``core.world.GridComm``): each leaf cut to the rank's block by the
    rule table, the model built with the rank's layout
    (``api.grid_model``)."""
    import dataclasses

    from repro_torch.models import api
    dtype = cfg.param_dtype if dtype is None else dtype
    if dtype != cfg.param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    if comm is not None:
        return api.grid_model(cfg, _map2(
            lambda a, s: torch.as_tensor(_np(a)).to(s.dtype), params_np,
            api.param_specs(cfg)), comm, device)
    params = api._to_specs(
        _tree_to_torch(_cut(params_np, cfg, expert_shard), device, None),
        api.param_specs(cfg, expert_shard=expert_shard))
    return api.build_model(cfg, params)


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _map2(fn, tree, specs):
    if isinstance(specs, dict):
        return {k: _map2(fn, tree[k], specs[k]) for k in specs}
    return fn(tree, specs)


def _cut(tree_np, cfg, expert_shard):
    """A rank's shard of a reference tree (numpy): each expert leaf cut to
    the rank's experts on its expert axis (axis 1, after the layer
    stack)."""
    if expert_shard is None or not cfg.moe:
        return tree_np
    from repro_torch.models import moe
    moe.check_expert_shards(cfg.moe.num_experts, expert_shard[1])
    return moe.cut_experts(tree_np, *expert_shard)


def join_expert_shards(shards: list):
    """The whole tree from every rank's shard (numpy or tensors, in rank
    order): each expert leaf concatenated on its expert axis, the other
    leaves taken from rank 0 -- the inverse of an ``expert_shard`` cut."""
    from repro_torch.models import moe

    def walk(trees, path):
        if isinstance(trees[0], dict):
            return {k: walk([t[k] for t in trees], path + (k,))
                    for k in trees[0]}
        if not moe.is_expert_path(path):
            return trees[0]
        if isinstance(trees[0], torch.Tensor):
            return torch.cat(trees, dim=1)
        return np.concatenate([np.asarray(t) for t in trees], axis=1)
    return walk(list(shards), ())


def lm_cache_from_reference(cache_np, *, device, dtype):
    """A reference decode cache (numpy; ``{"blocks": {"sub{j}": {"k", "v"}
    or {"ssm", "conv_x", "conv_B", "conv_C"}}}`` or ``{"decoder": {"k",
    "v", "xk", "xv"}}``, layer axis first) as the port's cache on
    ``device``: the two share the layout.  Every leaf is taken to
    ``dtype`` but the mamba state ``ssm``, which is f32 in every model, as
    in the reference."""
    if isinstance(cache_np, dict):
        return {k: (_tree_to_torch(v, device, torch.float32) if k == "ssm"
                    else lm_cache_from_reference(v, device=device,
                                                 dtype=dtype))
                for k, v in cache_np.items()}
    return _tree_to_torch(cache_np, device, dtype)


def lm_cache_to_numpy(cache) -> dict:
    """The port's decode cache as f32 numpy arrays, in the same tree."""
    if isinstance(cache, dict):
        return {k: lm_cache_to_numpy(v) for k, v in cache.items()}
    return cache.detach().float().cpu().numpy()


def train_state_from_reference(state_np, cfg, *, device,
                               expert_shard: tuple | None = None,
                               grid=None, coords: dict | None = None):
    """The port's train state (``repro_torch.train``: ``{"params", "opt":
    {"master", "m", "v"}, "step"}``) from the reference's, as numpy arrays
    in the same tree (the parameters in the reference's stacked layout):
    each leaf on ``device`` in the type
    :func:`~repro_torch.train.train_state_specs` gives it (the parameters
    in ``cfg.param_dtype`` with the f32 parameters f32, the optimizer
    state f32, the step int32); a bf16 leaf is carried through f32, which
    holds it exactly.  ``expert_shard=(rank, P)``: the rank's shard of a
    state whose experts are sharded over P ranks (the parameters' and the
    master's, m's and v's expert leaves cut as in
    :func:`lm_params_from_reference`).  ``grid`` / ``coords``: the blocks
    of the rank at ``coords`` on that grid
    (``train.trainer.train_step_shardings``)."""
    from repro_torch.models import api
    from repro_torch.train import train_state_specs
    if grid is not None:
        from repro_torch.train.elastic import reshard_state
        return reshard_state(
            api._to_specs(_tree_to_torch(state_np, "cpu", None),
                          train_state_specs(cfg)),
            cfg, device, grid=grid, coords=coords)
    return api._to_specs(
        _tree_to_torch(_cut(state_np, cfg, expert_shard), device, None),
        train_state_specs(cfg, expert_shard))


def train_state_to_numpy(state, comm=None) -> dict:
    """A train state of the port copied to numpy arrays in the same tree
    (copies: the train step updates the state in place): bf16 leaves as
    f32 (exact), the others in their own type.  ``comm``: the state is
    this rank's shard of experts sharded over ``comm``'s ranks (every
    rank must call it); rank 0 gets the whole (reference) tree, gathered
    to its host one layer of an expert leaf at a time, the other ranks
    ``None``."""
    if comm is not None and comm.size > 1:
        from repro_torch.models.moe import gather_experts
        state = gather_experts(state, comm)
        if state is None:
            return None
    if isinstance(state, dict):
        return {k: train_state_to_numpy(v) for k, v in state.items()}
    t = state.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
