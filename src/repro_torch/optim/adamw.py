"""AdamW with mixed precision, the twin of ``repro.optim.adamw``.

The layout (DESIGN.md section 3): the model's parameters in
``cfg.param_dtype`` (bf16 for the big archs); the optimizer owns an f32
master copy and f32 (m, v); gradients arrive in the parameters' dtype and
are upcast once for the update.  The reference shards (master, m, v) over
its 'data' axis (ZeRO-1); the port's data-parallel ranks each hold all of
it (``repro_torch.train.elastic``) but an MoE model's experts, of which a
rank holds and updates its own shard (``train.trainer``).

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

from repro_torch.models.module import ParamSpec, tree_leaves, tree_map

F32 = torch.float32


def _leaves(tree) -> list:
    return tree_leaves(tree, is_leaf=torch.is_tensor)


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


def _global_norm(tree, comm=None, sharded: list | None = None
                 ) -> torch.Tensor:
    """sqrt of the sum over the leaves (sorted-key order, as the
    reference's) of each f32-cast leaf's sum of squares.  With ``comm`` and
    ``sharded`` (for each leaf: is it this rank's shard of experts sharded
    over ``comm``'s ranks?) the norm is the whole tree's: the shards'
    squares are summed apart and over the ranks by one scalar all-reduce,
    then added to the replicated leaves'."""
    if comm is None:
        sq = 0
        for g in _leaves(tree):
            g32 = g.to(F32, copy=True)
            sq = sq + torch.sum(g32.mul_(g32))
        return torch.sqrt(sq)
    sq = [0, 0]
    for g, own in zip(_leaves(tree), sharded):
        g32 = g.to(F32, copy=True)
        sq[own] = sq[own] + torch.sum(g32.mul_(g32))
    shards = torch.as_tensor(sq[1], dtype=F32).reshape(1)
    return torch.sqrt(sq[0] + comm.all_reduce(shards.to(
        _leaves(tree)[0].device))[0])


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
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                           1.0)
    step = torch.as_tensor(step)
    lr = cfg.lr_at(step)
    t = (step + 1).to(F32)
    bc1 = 1 - torch.pow(cfg.b1, t)
    bc2 = 1 - torch.pow(cfg.b2, t)
    for p, g, master, m, v in zip(
            _leaves(params), _leaves(grads), _leaves(opt_state["master"]),
            _leaves(opt_state["m"]), _leaves(opt_state["v"])):
        g32 = g.to(F32, copy=True).mul_(clip)
        tmp = torch.mul(g32, 1 - cfg.b1)
        m.mul_(cfg.b1).add_(tmp)
        torch.mul(g32, 1 - cfg.b2, out=tmp).mul_(g32)
        v.mul_(cfg.b2).add_(tmp)
        den = torch.div(v, bc2, out=g32).sqrt_().add_(cfg.eps)
        upd = torch.div(m, bc1, out=tmp).div_(den)
        upd.add_(torch.mul(master, cfg.weight_decay, out=den)).mul_(lr)
        master.sub_(upd)
        p.copy_(master)
        del g32, tmp
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
