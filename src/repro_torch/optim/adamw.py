"""AdamW with mixed precision, the twin of ``repro.optim.adamw``.

The layout (DESIGN.md section 3): the model's parameters in
``cfg.param_dtype`` (bf16 for the big archs); the optimizer owns an f32
master copy and f32 (m, v); gradients arrive in the parameters' dtype and
are upcast once for the update.  On a grid of ranks (``train.trainer``)
(master, m, v) are ZeRO-1-sharded as the reference shards them: by the
fsdp rule set (``models.sharding``; the non-TP 'embed' dimension over
'data'), whatever the parameters' own rules (:func:`zero_plan`).  A rank
updates its block from the gradient of its parameter block (reduced over
the batch's ranks), then all-gathers the new parameter over the axes its
optimizer block spans beyond its parameter block
(:func:`adamw_update_zero`); the clip's norm counts each distinct
gradient element once.  On a 1-D world of ranks without a grid each rank
holds all of the state (``train.elastic``) but an MoE model's experts, of
which a rank holds and updates its own shard.

The update is the reference's arithmetic, operation for operation:
``g32 = g * clip``, ``m = b1 m + (1 - b1) g32``, ``v = b2 v + ((1 - b2)
g32) g32``, ``update = (m / bc1) / (sqrt(v / bc2) + eps)``, ``master =
master - lr (update + wd master)`` on every leaf (the norms and the
embeddings too), the new parameter ``master`` cast to its dtype (the f32
parameters -- mamba's ``A_log`` / ``D`` / ``dt_bias``, the router -- stay
f32).  ``torch.optim.AdamW`` is a different update (decay as ``p *= 1 -
lr wd``, the bias corrections folded into the step size, no master, no
clip), so the port applies this one itself: leaf by leaf and in place, so
that a leaf costs two f32 temporaries of its size (1.6 GB each for
llama3.2-3b's embedding) and the state is never copied.  The scalars
(clip, lr, the bias corrections) stay 0-d f32 tensors on the device: the
update never waits for the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.module import (ParamSpec, tensor_leaves, tree_leaves,
                                       tree_map)
from repro_torch.models.sharding import entry_axes, make_rules, spec_axes

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def lr_at(self, step):
        """The learning rate at ``step`` as a 0-d f32 tensor (on the step's
        device)."""
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=F32,
                            device=torch.as_tensor(step).device)


def opt_state_specs(param_specs_tree) -> dict:
    """ParamSpec tree for (master, m, v): f32, the parameters' axes."""
    def f32_spec(s: ParamSpec) -> ParamSpec:
        return ParamSpec(s.shape, s.axes, F32, init="zeros")

    def master_spec(s: ParamSpec) -> ParamSpec:
        return ParamSpec(s.shape, s.axes, F32, init=s.init, scale=s.scale)

    return {"master": tree_map(master_spec, param_specs_tree),
            "m": tree_map(f32_spec, param_specs_tree),
            "v": tree_map(f32_spec, param_specs_tree)}


def init_opt_state(params) -> dict:
    """(master, m, v) for a parameter tree: the master is the parameters
    cast to f32 (so a bf16 model's master starts from the bf16-rounded
    values), m and v are zeros."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)
    return {"master": tree_map(lambda p: p.to(F32, copy=True), params,
                               is_leaf=torch.is_tensor),
            "m": tree_map(zeros, params, is_leaf=torch.is_tensor),
            "v": tree_map(zeros, params, is_leaf=torch.is_tensor)}


def _norm_dtype(tree) -> torch.dtype:
    """The norm's type: f32, or f64 where a gradient is f64."""
    out = F32
    for g in tensor_leaves(tree):
        out = torch.promote_types(out, g.dtype)
    return out


def _square_sum(g) -> torch.Tensor:
    """A gradient's sum of squares in f32 (f64 for an f64 gradient)."""
    g32 = g.to(torch.promote_types(g.dtype, F32), copy=True)
    return torch.sum(g32.mul_(g32))


def _global_norm(tree, comm=None, sharded: list | None = None
                 ) -> torch.Tensor:
    """sqrt of the sum over the leaves (sorted-key order, as the
    reference's) of each f32-cast leaf's sum of squares (an f64 leaf's in
    f64: the reference's x64 runs cast to f32).  With ``comm`` and
    ``sharded`` (for each leaf: is it this rank's shard of experts sharded
    over ``comm``'s ranks?) the norm is the whole tree's: the shards'
    squares are summed apart and over the ranks by one scalar all-reduce,
    then added to the replicated leaves'."""
    if comm is None:
        sq = 0
        for g in tensor_leaves(tree):
            sq = sq + _square_sum(g)
        return torch.sqrt(sq)
    sq = [0, 0]
    for g, own in zip(tensor_leaves(tree), sharded):
        sq[own] = sq[own] + _square_sum(g)
    shards = torch.as_tensor(sq[1], dtype=_norm_dtype(tree)).reshape(1)
    return torch.sqrt(sq[0] + comm.all_reduce(shards.to(
        tensor_leaves(tree)[0].device))[0])


def adamw_update(params, grads, opt_state, step, cfg: AdamWConfig,
                 comm=None, sharded: list | None = None):
    """One AdamW step, in place: the leaves of ``params`` and of
    ``opt_state``'s master, m and v are updated where they lie and the same
    trees are returned, (params, opt_state, {"grad_norm", "lr"}) (the
    reference returns new trees).  ``step`` is the 0-d step counter before
    the update.  ``comm`` / ``sharded``: the trees hold this rank's shard
    of experts sharded over ``comm``'s ranks (:func:`_global_norm`: the
    clip is the whole tree's); each rank updates its own leaves."""
    gnorm = _global_norm(grads, comm, sharded)
    lr, scalars = _scalars(gnorm, step, cfg)
    for p, g, master, m, v in zip(
            *map(tensor_leaves, (params, grads, *_opt_trees(opt_state)))):
        _update_leaf(g, master, m, v, scalars, cfg)
        p.copy_(master)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def _opt_trees(opt_state) -> tuple:
    return opt_state["master"], opt_state["m"], opt_state["v"]


def _scalars(gnorm, step, cfg: AdamWConfig) -> tuple:
    """(lr, (clip, lr, bc1, bc2)) of a step: 0-d f32 tensors."""
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                           1.0)
    step = torch.as_tensor(step)
    lr = cfg.lr_at(step)
    t = (step + 1).to(F32)
    return lr, (clip, lr, 1 - torch.pow(cfg.b1, t), 1 - torch.pow(cfg.b2, t))


def _update_leaf(g, master, m, v, scalars: tuple, cfg: AdamWConfig) -> None:
    """One leaf's update of (master, m, v) in place from its gradient ``g``
    (the same shape: a whole leaf, or a rank's block of it)."""
    clip, lr, bc1, bc2 = scalars
    g32 = g.to(F32, copy=True).mul_(clip)
    tmp = torch.mul(g32, 1 - cfg.b1)
    m.mul_(cfg.b1).add_(tmp)
    torch.mul(g32, 1 - cfg.b2, out=tmp).mul_(g32)
    v.mul_(cfg.b2).add_(tmp)
    den = torch.div(v, bc2, out=g32).sqrt_().add_(cfg.eps)
    upd = torch.div(m, bc1, out=tmp).div_(den)
    upd.add_(torch.mul(master, cfg.weight_decay, out=den)).mul_(lr)
    master.sub_(upd)


# ------------------------------------------------------------- ZeRO-1 --

@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How one leaf lies on a grid: the spec of its parameter block
    (``param``) and of its optimizer block (``opt``); ``gather``, the
    (dimension, axis) its new parameter is all-gathered over after the
    update (the optimizer block cut further than the parameter's), or
    ``None``; ``count``, does this rank's block count in the global norm
    (every grid axis the parameter is replicated over at coordinate 0)."""
    param: tuple
    opt: tuple
    gather: tuple | None
    count: bool


def _extra(param: tuple, opt: tuple, grid: dict) -> tuple | None:
    """The (dim, axis) the optimizer block cuts beyond the parameter's
    (axes of one rank drop out)."""
    extra = []
    for d, (pe, oe) in enumerate(zip(param, opt)):
        pa, oa = entry_axes(pe), entry_axes(oe)
        if oa[:len(pa)] != pa:
            raise NotImplementedError(
                f"an optimizer block cut {opt} that does not refine its "
                f"parameter's {param}")
        extra += [(d, a) for a in oa[len(pa):] if grid[a] > 1]
    if len(extra) > 1:
        raise NotImplementedError(f"optimizer block {opt} cuts its "
                                  f"parameter's {param} on more than one "
                                  "axis")
    return extra[0] if extra else None


def zero_plan(param_specs_tree, fsdp: bool, grid: dict, coords: dict
              ) -> list:
    """The :class:`LeafPlan` of every leaf (tree order) of a parameter
    spec tree on ``grid`` at ``coords``: parameters under the rule table
    with ``fsdp``, (master, m, v) under the fsdp rule set (ZeRO-1, as the
    reference's ``train_step_shardings``)."""
    prules = make_rules(grid, fsdp=fsdp)
    orules = make_rules(grid, fsdp=True)
    plans = []
    for s in tree_leaves(param_specs_tree):
        param, opt = prules.spec_of(s), orules.spec_of(s)
        held = spec_axes(param)
        count = all(coords[a] == 0 for a, n in grid.items()
                    if n > 1 and a not in held)
        plans.append(LeafPlan(param, opt, _extra(param, opt, grid), count))
    return plans


def opt_block(p, lp: LeafPlan, comm) -> torch.Tensor:
    """The rank's optimizer block of its parameter block ``p`` (a
    view)."""
    if lp.gather is None:
        return p
    d, axis = lp.gather
    size = p.shape[d] // comm.grid[axis]
    return p.narrow(d, comm.coords[axis] * size, size)


def adamw_update_zero(params, grads, opt_state, step, cfg: AdamWConfig,
                      plan: list, comm):
    """One AdamW step on a grid (``comm``: the rank's
    ``core.world.GridComm``; ``plan``: :func:`zero_plan`), in place:
    ``params`` and ``grads`` are the rank's parameter blocks and their
    gradients (reduced over the batch's ranks), ``opt_state`` its
    optimizer blocks.  The global norm sums the squares of the blocks
    that count (:class:`LeafPlan`) with one scalar all-reduce over the
    grid; each leaf's optimizer block is updated from its part of the
    gradient, and the new parameter block all-gathered over the axis the
    optimizer block cuts further.  The arithmetic is
    :func:`adamw_update`'s, element for element."""
    dev = comm.device
    sq = 0
    for g, lp in zip(tensor_leaves(grads), plan):
        if lp.count:
            sq = sq + _square_sum(g)
    sq = torch.as_tensor(sq, dtype=_norm_dtype(grads), device=dev).reshape(1)
    if comm.size > 1:
        sq = comm.world.all_reduce(sq)
    gnorm = torch.sqrt(sq[0])
    lr, scalars = _scalars(gnorm, step, cfg)
    for p, g, master, m, v, lp in zip(
            *map(tensor_leaves, (params, grads, *_opt_trees(opt_state))),
            plan):
        _update_leaf(opt_block(g, lp, comm), master, m, v, scalars, cfg)
        if lp.gather is None:
            p.copy_(master)
        else:
            d, axis = lp.gather
            parts = comm.axis(axis).all_gather(master.to(p.dtype))
            p.copy_(torch.cat(parts.unbind(0), dim=d))
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
