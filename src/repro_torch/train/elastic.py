"""Elastic scaling: restart the same logical job on a different number of
ranks, the twin of ``repro.train.elastic``.

Checkpoints store logical (unsharded) trees, so elasticity is a placement
problem.  The reference builds a (pod x data x model) mesh for the new
world and re-derives its shardings; the port trains data-parallel: a
world of P ranks (``core.world.SolverWorld``: spawned processes on one
``torch.distributed`` group; nccl with a card per rank, or gloo ranks
sharing a card or the CPU), each holding the whole state but an MoE
model's experts, which are sharded over the ranks (E / P a rank, the
reference's 'model' axis for experts; ``train.trainer``).  There is no
tensor-parallel axis for the other weights and the optimizer state is
replicated, not ZeRO-1-sharded over 'data' as in the reference.  So a
restart on another P is :func:`reshard_state` (every rank cuts its
experts from the restored tree and places its part on its device) and
:func:`run_data_parallel` on the new world.

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
from .trainer import Trainer, train_state_specs


def plan_mesh(n_devices: int) -> int:
    """The data-parallel ranks for a world of ``n_devices``: all of them.
    The reference also folds a tensor-parallel 'model' axis into its
    mesh; the port has none, so every device holds a replica of all but
    an MoE model's experts, which are sharded over them."""
    check_positive_int("n_devices", n_devices)
    return n_devices


def reshard_state(state, model_cfg, device, expert_shard: tuple | None = None):
    """Place a logical train state (a restored host tree, or another
    world's) on ``device``, every leaf checked against the shape and dtype
    :func:`~repro_torch.train.trainer.train_state_specs` gives
    ``model_cfg``; with ``expert_shard=(rank, P)`` only the rank's experts
    of each expert leaf (E % P == 0), cut where the tree lies before it
    moves."""
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
        trainer.state, replicated_only=trainer.expert_shard is not None)}
    state = trainer.logical_state()
    if comm.rank == 0:
        out["state"] = tree_map(lambda t: t.detach().cpu(), state,
                                is_leaf=torch.is_tensor)
    return out


def run_data_parallel(world, model_cfg, run_cfg, n_ranks: int | None = None
                      ) -> dict:
    """``Trainer(model_cfg, run_cfg).run()`` on the first ``n_ranks`` ranks
    of ``world`` (a ``SolverWorld``; all by default), restoring from and
    saving to ``run_cfg.ckpt_dir`` when set (rank 0 writes).  Raises if the
    ranks' final replicated leaves are not the same bytes.  Returns rank
    0's ``{"history", "state"}`` (the whole state on the CPU, an MoE
    model's experts gathered from the ranks) and the ranks' ``digests``."""
    outs = world.run(_rank_train, n_ranks, model_cfg=model_cfg,
                     run_cfg=run_cfg)
    digests = [o["digest"] for o in outs]
    if len(set(digests)) != 1:
        raise RuntimeError(f"the replicated train state differs between "
                           f"ranks: {digests}")
    return {"history": outs[0]["history"], "state": outs[0]["state"],
            "digests": digests}
