"""Elastic scaling: restart the same logical job on a different number of
ranks, the twin of ``repro.train.elastic``.

Checkpoints store logical (unsharded) trees, so elasticity is a placement
problem.  As the reference builds a (pod x data x model) mesh for the new
world and re-derives its shardings from the rule table, the port lays the
ranks of a world (``core.world.SolverWorld``: spawned processes on one
``torch.distributed`` group; nccl with a card per rank, or gloo ranks
sharing a card or the CPU) out as a grid (:func:`plan_mesh`, the
reference's arithmetic) and cuts every leaf of the restored tree by the
rules (:func:`reshard_state` with ``grid`` / ``coords``): tensor
parallelism over 'model', the optimizer state ZeRO-1-sharded over
'data', FSDP where the config asks for it (``train.trainer``).  A state
written on one grid restarts on any other whose axes divide its leaves as
the rules need.  Without a grid, a world of P ranks trains
data-parallel, each rank holding the whole state but an MoE model's
experts, which are sharded over the ranks (E / P a rank, the reference's
'model' axis for experts).

Every rank reads the same global batch (a ``num_hosts=1`` stream: P
streams of ``num_hosts=P`` are other Philox streams, so P ranks would not
equal one) and trains on its rows (``train.trainer``).  After a run the
replicas are checked to be the same bytes on every rank, as
``SolverWorld`` checks a solve's replicated iterate (the replicated leaves
only: the expert shards differ by design).
"""
from __future__ import annotations

import hashlib

import torch

from repro_torch.core.engine import check_positive_int
from repro_torch.models import moe
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.core.grid import as_grid
from repro_torch.models.sharding import cut_tree
from .trainer import Trainer, train_state_specs, train_step_shardings


def plan_mesh(n_devices: int, tp: int = 16, pods: int | None = None
              ) -> dict:
    """Choose the (pod, data, model) grid for a world size, the reference's
    arithmetic: the tensor-parallel degree is at most ``tp`` and the
    device count, halved until it divides the count; the data axis takes
    the rest, split over ``pods`` when they divide it."""
    check_positive_int("n_devices", n_devices)
    tp = min(tp, n_devices)
    while n_devices % tp:
        tp //= 2
    rest = n_devices // tp
    if pods and rest % pods == 0 and pods > 1:
        return {"pod": pods, "data": rest // pods, "model": tp}
    return {"data": rest, "model": tp}


def reshard_state(state, model_cfg, device, expert_shard: tuple | None = None,
                  *, grid=None, coords: dict | None = None):
    """Place a logical train state (a restored host tree, or another
    world's) on ``device``, every leaf checked against the shape and dtype
    :func:`~repro_torch.train.trainer.train_state_specs` gives
    ``model_cfg``; with ``expert_shard=(rank, P)`` only the rank's experts
    of each expert leaf (E % P == 0), cut where the tree lies before it
    moves; with ``grid`` and ``coords`` the blocks of the rank at
    ``coords`` on that grid (``train.trainer.train_step_shardings``), each
    cut where the tree lies and copied."""
    def check(t, spec):
        t = torch.as_tensor(t)
        if tuple(t.shape) != spec.shape or t.dtype != spec.dtype:
            raise ValueError(f"state leaf {tuple(t.shape)} {t.dtype} does "
                             f"not match the spec {spec.shape} {spec.dtype}")
        return t

    def walk(tree, specs):
        if isinstance(specs, dict):
            if set(tree) != set(specs):
                raise ValueError(f"state keys {sorted(tree)} do not match "
                                 f"{sorted(specs)}")
            return {k: walk(tree[k], specs[k]) for k in specs}
        return check(tree, specs)

    state = walk(state, train_state_specs(model_cfg))
    if grid is not None:
        grid = as_grid(grid)
        shardings, _ = train_step_shardings(model_cfg, grid)
        return cut_tree(state, shardings, grid, coords, device=device)
    if expert_shard is not None and model_cfg.moe:
        moe.check_expert_shards(model_cfg.moe.num_experts, expert_shard[1])
        state = moe.map_experts(lambda t: t.to(device, copy=True),
                                moe.cut_experts(state, *expert_shard))
    return tree_map(lambda t: t.to(device), state, is_leaf=torch.is_tensor)


def state_digest(state, replicated_only: bool = False) -> str:
    """SHA-256 of every leaf's bytes, in the tree's sorted-key order (with
    ``replicated_only``, every leaf but the expert shards)."""
    h = hashlib.sha256()
    leaves = tree_leaves(state, is_leaf=torch.is_tensor)
    if replicated_only:
        leaves = [t for t, own in zip(leaves, moe.expert_mask(state))
                  if not own]
    for t in leaves:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _rank_train(comm, device, *, model_cfg, run_cfg) -> dict:
    """One rank's part of :func:`run_data_parallel`."""
    trainer = Trainer(model_cfg, run_cfg, comm)
    history = trainer.run()
    out = {"history": history, "digest": state_digest(
        trainer.state, replicated_only=trainer.expert_shard is not None),
        "opt_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(
            trainer.state["opt"], is_leaf=torch.is_tensor))}
    state = trainer.logical_state()
    if comm.rank == 0:
        out["state"] = tree_map(lambda t: t.detach().cpu(), state,
                                is_leaf=torch.is_tensor)
    del trainer, state
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()    # the ranks may share the card
    return out


def run_data_parallel(world, model_cfg, run_cfg, n_ranks: int | None = None,
                      *, grid=None) -> dict:
    """``Trainer(model_cfg, run_cfg).run()`` on the first ``n_ranks`` ranks
    of ``world`` (a ``SolverWorld``; all by default), restoring from and
    saving to ``run_cfg.ckpt_dir`` when set (rank 0 writes).  Raises if the
    ranks' final replicated leaves are not the same bytes.  Returns rank
    0's ``{"history", "state"}`` (the whole state on the CPU, an MoE
    model's experts gathered from the ranks), the ranks' ``digests`` and
    each rank's optimizer bytes (``opt_bytes``).  With ``grid`` the ranks
    are laid out on it (``SolverWorld.run_grid``; ``n_ranks`` is its
    size): the state is assembled from the ranks' blocks, the replicated
    ones checked to be the same bits, and the digests are each rank's
    own blocks'."""
    if grid is not None:
        outs = world.run_grid(_rank_train, grid, model_cfg=model_cfg,
                              run_cfg=run_cfg)
        return {"history": outs[0]["history"], "state": outs[0]["state"],
                "digests": [o["digest"] for o in outs],
                "opt_bytes": [o["opt_bytes"] for o in outs]}
    outs = world.run(_rank_train, n_ranks, model_cfg=model_cfg,
                     run_cfg=run_cfg)
    digests = [o["digest"] for o in outs]
    if len(set(digests)) != 1:
        raise RuntimeError(f"the replicated train state differs between "
                           f"ranks: {digests}")
    return {"history": outs[0]["history"], "state": outs[0]["state"],
            "digests": digests, "opt_bytes": [o["opt_bytes"] for o in outs]}
