"""Training loop: the train_step factory and the Trainer driver, the twin
of ``repro.train.trainer``.

The train step is the reference's: gradient accumulation over microbatches
into f32 accumulators (each microbatch's gradient cast to f32 and divided
by the count before it is added), gradients in the parameters' dtype (on a
world of ranks, that dtype is the wire's: bf16 for a bf16 model), AdamW
with an f32 master and moments.  The reference's is one jitted program
over a sharded state; here a step builds the model on the state's
parameter tree (views, no copy; :meth:`~repro_torch.models.api._LM.trainable`),
runs backward into gradient buffers laid out as that tree, and updates the
state in place (``optim.adamw_update``), so a step holds the state once
and its gradients once.

On a data-parallel world (``comm`` of P > 1 ranks, ``train.elastic``)
every rank reads the same global batch and takes its own rows of it; its
loss is its rows' NLL over the global batch's mask count, so the ranks'
gradients sum to the global batch's, and one all-reduce a microbatch (one
for each dtype among the gradients: one for every model without f32
parameters) sums them; the reported loss is summed by one more scalar
all-reduce.  Every rank then makes the same update on its replica.

An MoE model's experts are sharded over the P ranks (``models.moe``;
``E % P == 0``, else ``ValueError``): a rank's state holds E / P experts
of every MoE layer (:func:`train_state_specs` with ``expert_shard``), and
each microbatch's dispatch is ONE over the global microbatch, as the
reference's mesh dispatches it (the capacity, the drops, the aux loss and
the drop fraction are the global batch's).  The rank's loss adds the aux
loss once over the world (``aux / P`` on every rank; its backward
all-reduces the probability sums' gradient), the all-reduces sum the
replicated leaves' gradients only (an expert's gradient is whole on its
owner after the all-to-all's backward), the gradient norm adds the
expert shards' squared norms with one scalar all-reduce, so clipping is
the whole tree's, and AdamW updates each rank's own shard.

On a grid of ranks (``comm`` a ``core.world.GridComm``: (pod, data,
model), ``models.sharding``) the step is the reference's production
layout: every leaf a rank's block under the rule table
(:func:`train_step_shardings`: parameters under ``cfg.fsdp``, the f32
(master, m, v) under the fsdp rule set, ZeRO-1); a rank takes its rows of
the batch by its (pod, data) coordinates (the frontend embeddings'
rows with them, where the batch carries them); the dense decoder, the
vlm, the encoder-decoder and the ssm family run tensor-parallel over
'model' and, with ``cfg.fsdp``, gather each layer's
weights over 'data' just before use (``models.api.GridLayout``); the
gradients are all-reduced over the batch's ranks (a leaf FSDP cuts is
reduce-scattered over 'data' by its gather's backward instead, and
all-reduced over 'pod'), and ``optim.adamw_update_zero`` updates the
rank's optimizer blocks.  On a grid whose 'model' axis is one rank and
without FSDP the model runs as on one rank: the data-parallel step with
ZeRO-1, the same bits as the replicated world's (its gradients
all-reduced in one buffer a dtype over the same ranks, its updates the
same element operations).  :func:`abstract_train_state` is the rank's
tree of ``meta`` tensors (the reference's ``ShapeDtypeStruct`` tree).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.engine import all_reduce_variadic
from repro_torch.core.world import GridComm
from repro_torch.data import TokenStream
from repro_torch.data.regression import check_device
from repro_torch.models import api, moe
from repro_torch.models.module import (ParamSpec, init_params, tensor_leaves,
                                       tree_map)
from repro_torch.core.grid import as_grid
from repro_torch.models.sharding import (assemble, cut_tree, make_rules,
                                         map_specs, shard_shape, spec_axes)
from repro_torch.optim import (AdamWConfig, adamw_update, init_opt_state,
                               opt_state_specs)
from repro_torch.optim.adamw import adamw_update_zero, zero_plan
from repro_torch.optim.schedules import cosine_warmup

TrainState = dict  # {"params", "opt": {"master", "m", "v"}, "step"}
F32 = torch.float32


# ---------------------------------------------------------------- specs ----

def expert_shard_of(model_cfg, comm) -> tuple | None:
    """``(rank, P)`` where ``comm``'s ranks shard an MoE model's experts
    (P > 1), else ``None``; raises where E % P != 0."""
    if comm is None or comm.size == 1 or not model_cfg.moe:
        return None
    moe.check_expert_shards(model_cfg.moe.num_experts, comm.size)
    return (comm.rank, comm.size)


def train_state_specs(model_cfg, expert_shard: tuple | None = None) -> dict:
    """The train state's specs; with ``expert_shard=(rank, P)`` a rank's
    shard of experts sharded over P ranks (``api.param_specs``)."""
    pspecs = api.param_specs(model_cfg, expert_shard=expert_shard)
    return {"params": pspecs, "opt": opt_state_specs(pspecs),
            "step": ParamSpec((), (), torch.int32, init="zeros")}


def train_step_shardings(model_cfg, grid) -> tuple:
    """(state specs, batch specs): every leaf's spec on ``grid`` (the
    reference's ``NamedSharding`` trees as spec tuples,
    ``models.sharding``): the parameters under the rule table with
    ``cfg.fsdp``, (master, m, v) under the fsdp rule set (ZeRO-1), the
    step replicated; the batch's rows over (pod, data)."""
    prules = make_rules(grid, fsdp=model_cfg.fsdp)
    zrules = make_rules(grid, fsdp=True)
    specs = train_state_specs(model_cfg)
    state = {"params": prules.tree(specs["params"]),
             "opt": zrules.tree(specs["opt"]), "step": ()}
    bspec = prules.spec_for((1 << 30, 1), ("batch", "seq"))
    batch = {"tokens": bspec, "labels": bspec, "mask": bspec}
    key = frontend_key(model_cfg)
    if key is not None:
        batch[key] = prules.spec_for((1 << 30, 1, 1),
                                     ("batch", "seq", "embed"))
    return state, batch


def frontend_key(model_cfg) -> str | None:
    """The batch key of the family's frontend embeddings: the audio
    family's encoder frames, the vlm's patch prefix, or ``None``."""
    return {"audio": "src_embeds", "vlm": "extra_embeds"}.get(
        model_cfg.family)


def frontend_embeds(model_cfg, rows: int, seq_len: int, seed: int,
                    step: int) -> dict:
    """The frontend stub's embeddings of a step's global batch of ``rows``
    rows of ``seq_len`` tokens, where the family takes them (the
    reference's input specs): the audio family's ``api.cross_frames(S)``
    encoder frames a row (``src_embeds``), the vlm's ``frontend_tokens``
    patch embeddings (``extra_embeds``, prefixed to the tokens); ``{}``
    for the others.  N(0, 0.02^2) in f32 (``launch.inputs.materialize``'s
    scale) from a stream keyed on (seed, step): every rank draws the same
    global batch and takes its rows, and a resumed run the same
    embeddings."""
    key = frontend_key(model_cfg)
    if key is None:
        return {}
    n = (api.cross_frames(seq_len) if model_cfg.family == "audio"
         else model_cfg.frontend_tokens)
    rng = np.random.default_rng((seed, step, 1))
    return {key: rng.standard_normal((rows, n, model_cfg.d_model),
                                     dtype=np.float32) * np.float32(0.02)}


def abstract_train_state(model_cfg, grid) -> dict:
    """A rank's train state on ``grid`` as ``meta`` tensors of its blocks'
    shapes and dtypes (nothing allocated; the reference's
    ``ShapeDtypeStruct`` tree with shardings)."""
    shardings, _ = train_step_shardings(model_cfg, grid)
    return map_specs(lambda s, sh: torch.empty(
        shard_shape(s.shape, sh, grid), dtype=s.dtype, device="meta"),
        train_state_specs(model_cfg), shardings)


def gather_state(state, model_cfg, comm) -> TrainState | None:
    """The logical train state from every rank's blocks on ``comm``'s
    grid, on rank 0's host (``None`` on the other ranks; every rank must
    call it): one all-gather over the grid a leaf, the replicated blocks
    checked to be the same bits (``models.sharding.assemble``)."""
    shardings, _ = train_step_shardings(model_cfg, comm.grid)

    def walk(t, sh):
        if isinstance(t, dict):
            return {k: walk(t[k], sh[k]) for k in sorted(t)}
        parts = comm.world.all_gather(t.contiguous()).cpu()
        return (assemble(list(parts.unbind(0)), sh, comm.grid)
                if comm.rank == 0 else None)
    out = walk(state, shardings)
    return out if comm.rank == 0 else None


def place_fresh(params, model_cfg, comm) -> TrainState:
    """A fresh train state's blocks on ``comm``'s grid from the whole
    parameters ``params``: the parameter blocks copied, the master block
    of each leaf its optimizer block in f32, m and v zeros."""
    shardings, _ = train_step_shardings(model_cfg, comm.grid)
    grid, at = comm.grid, comm.coords
    master = cut_tree(params, shardings["opt"]["master"], grid, at, F32)
    zeros = (lambda: tree_map(torch.zeros_like, master,
                              is_leaf=torch.is_tensor))
    return {"params": cut_tree(params, shardings["params"], grid, at),
            "opt": {"master": master, "m": zeros(), "v": zeros()},
            "step": torch.zeros((), dtype=torch.int32, device=comm.device)}


# ----------------------------------------------------------- train step ----

def _rows(batch: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in batch.items()}


def _reduce_grads(grads: dict, comm, sharded: list | None = None) -> None:
    """Sum the gradient buffers over the ranks in place: one all-reduce
    for each dtype among them, in that dtype.  ``sharded``: for each leaf,
    is it a rank's own expert shard (whole on its owner: not summed)?"""
    leaves = tensor_leaves(grads)
    by_dtype: dict = {}
    for g, own in zip(leaves, sharded or [False] * len(leaves)):
        if not own:
            by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        for g, r in zip(group, all_reduce_variadic(group, comm)):
            g.copy_(r)


def make_train_step(model_cfg, opt_cfg: AdamWConfig, microbatches: int = 1,
                    comm=None):
    """``train_step(state, batch) -> (state, metrics)``.  The state is
    updated in place and returned (the reference returns a new one);
    ``batch`` holds numpy arrays or tensors, moved to the parameters'
    device.  The metrics are the last microbatch's ``loss`` / ``ppl_log``
    (and ``moe_aux_loss``), the step's ``grad_norm`` and ``lr``, as 0-d
    tensors.  ``comm``: this rank's handle on a data-parallel world
    (module docstring); an MoE state then holds the rank's shard of the
    experts (:func:`expert_shard_of`).  With a ``core.world.GridComm``
    the step is the grid's (module docstring) on the rank's blocks."""
    if isinstance(comm, GridComm):
        return _make_grid_step(model_cfg, opt_cfg, microbatches, comm)
    P = 1 if comm is None else comm.size
    if microbatches < 1:
        raise ValueError(f"microbatches={microbatches} must be >= 1")
    shard = expert_shard_of(model_cfg, comm)
    n_moe = (max(model_cfg.n_layers // model_cfg.moe.every_n_layers, 1)
             if model_cfg.moe else 1)

    def backward(model, mb: dict, sharded: list | None) -> dict:
        """Gradients of one microbatch into the model's buffers (summed
        over the ranks but for the expert shards, ``sharded``); returns its
        metrics."""
        if P == 1:
            total, metrics = api.loss_fn(model, model_cfg, mb)
        else:
            B = len(mb["labels"])
            if B % P:
                raise ValueError(f"a microbatch of {B} rows does not split "
                                 f"over {P} ranks")
            mask = mb.get("mask")
            count = torch.clamp_min(
                torch.as_tensor(B * mb["labels"].shape[1], dtype=F32)
                if mask is None else mask.sum(), 1)
            n = B // P
            part, _, aux = api.nll_sum(
                model, model_cfg, _rows(mb, comm.rank * n,
                                        (comm.rank + 1) * n),
                comm if shard else None)
            total = part / count.to(part)
            metrics = {"loss": total}
            if shard:           # the aux loss once over the world
                total = total + aux["moe_aux_loss"] / (n_moe * P)
                metrics["moe_aux_loss"] = aux["moe_aux_loss"]
        total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if P > 1:
            _reduce_grads(model.grad_tree(), comm, sharded)
            loss = comm.all_reduce(metrics["loss"].reshape(1))[0]
            metrics = {**metrics, "loss": loss, "ppl_log": loss}
        return metrics

    sharded = (moe.expert_mask(api.param_specs(model_cfg, expert_shard=shard))
               if shard else None)

    def update(params, grads, state):
        return adamw_update(params, grads, state["opt"], state["step"],
                            opt_cfg, comm=comm if shard else None,
                            sharded=sharded)

    return _step_loop(model_cfg, microbatches, None,
                      lambda model, mb: backward(model, mb, sharded), update)


def _step_loop(model_cfg, microbatches: int, layout, backward, update):
    """The train step around a microbatch's ``backward(model, mb) ->
    metrics`` (its gradients left in the model's buffers, reduced over the
    ranks) and ``update(params, grads, state) -> (params, opt, metrics)``:
    the model built on the state's parameters, the microbatches'
    gradients accumulated in f32, the update, the step counted."""
    def train_step(state: TrainState, batch: dict):
        params = state["params"]
        dev = state["step"].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        model = api.build_model(model_cfg, params, layout).trainable()
        if microbatches == 1:
            metrics = backward(model, batch)
            grads = model.grad_tree()
        else:
            B = len(batch["labels"])
            if B % microbatches:
                raise ValueError(f"a batch of {B} rows does not split into "
                                 f"{microbatches} microbatches")
            n = B // microbatches
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                   device=p.device),
                             params, is_leaf=torch.is_tensor)
            for i in range(microbatches):
                if i:
                    model.zero_grad_tree()
                metrics = backward(model, _rows(batch, i * n, (i + 1) * n))
                for a, g in zip(tensor_leaves(grads),
                                tensor_leaves(model.grad_tree())):
                    a.add_(g.to(F32) / microbatches)
        with torch.no_grad():
            _, _, om = update(params, grads, state)
        del model, grads
        state["step"] = state["step"] + 1
        return state, {**metrics, **om, "loss": metrics["loss"]}

    return train_step


def _batch_index(comm: GridComm) -> tuple[int, int]:
    """(this rank's index, count) of the batch's ranks, (pod, data)
    row-major."""
    index, count = 0, 1
    for a in ("pod", "data"):
        if a in comm.grid:
            index = index * comm.grid[a] + comm.coords[a]
            count *= comm.grid[a]
    return index, count


def _make_grid_step(model_cfg, opt_cfg: AdamWConfig, microbatches: int,
                    comm: GridComm):
    """The train step on a grid (module docstring)."""
    if microbatches < 1:
        raise ValueError(f"microbatches={microbatches} must be >= 1")
    layout = api.grid_layout(model_cfg, comm)
    plan = zero_plan(api.param_specs(model_cfg), model_cfg.fsdp, comm.grid,
                     comm.coords)
    # a leaf FSDP cuts over 'data' is summed there by its gather's backward
    cut_data = [layout is not None and layout.fsdp
                and "data" in spec_axes(lp.param) for lp in plan]
    at, nb = _batch_index(comm)
    batch_comm, pod_comm = comm.batch, comm.axis("pod")

    def backward(model, mb: dict) -> dict:
        B = len(mb["labels"])
        if B % nb:
            raise ValueError(f"a microbatch of {B} rows does not split "
                             f"over {nb} batch ranks")
        mask = mb.get("mask")
        count = torch.clamp_min(
            torch.as_tensor(B * mb["labels"].shape[1], dtype=F32)
            if mask is None else mask.sum(), 1)
        n = B // nb
        part, _, _ = api.nll_sum(model, model_cfg,
                                 _rows(mb, at * n, (at + 1) * n))
        total = part / count.to(part)
        total.backward()
        loss = total.detach()
        grads = model.grad_tree()
        if batch_comm is not None:
            _reduce_grads(grads, batch_comm, cut_data)
            loss = batch_comm.all_reduce(loss.reshape(1))[0]
        if pod_comm is not None and any(cut_data):
            _reduce_grads(grads, pod_comm, [not c for c in cut_data])
        return {"loss": loss, "ppl_log": loss}

    def update(params, grads, state):
        return adamw_update_zero(params, grads, state["opt"], state["step"],
                                 opt_cfg, plan, comm)

    return _step_loop(model_cfg, microbatches, layout, backward, update)


# ---------------------------------------------------------------- driver ----

@dataclasses.dataclass
class TrainRunConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 256
    lr: float = 3e-4
    warmup: int = 20
    microbatches: int = 1
    seed: int = 0
    ckpt_dir: str | None = None
    save_every: int = 50
    keep: int = 3
    log_every: int = 10


class Trainer:
    """End-to-end driver: data -> step -> checkpoint / resume.

    ``comm``: this rank's handle on a data-parallel world (the reference's
    ``mesh``; ``train.elastic.run_data_parallel`` starts one Trainer a
    rank); the rank's device is then the world's.  Without it the Trainer
    runs on ``device`` (the card unless the caller asks for the CPU).
    Fresh weights come from a ``torch.Generator`` seeded with
    ``run_cfg.seed`` on the device (not ``jax.random``'s stream).  Rank 0
    alone logs and writes the checkpoints; every rank restores.  An MoE
    model's experts are sharded over the ranks (:func:`expert_shard_of`):
    a rank's fresh state is its cut of the expert-by-expert draw
    (``api.init_shard``, the same stream on one rank), a checkpoint
    holds the whole (logical) state, gathered to rank 0's host before it
    writes it, and a restore cuts the rank's experts from it, so a state
    written on P ranks restarts on any P' with E % P' == 0.

    ``grid``: ``comm`` is the rank's ``core.world.GridComm`` on this grid
    (``train.elastic.run_data_parallel(..., grid=...)``): the state is the
    rank's blocks by the rules (:func:`train_step_shardings`), a fresh one
    cut from the one-rank draw, a restored one from the logical tree;
    :meth:`logical_state` assembles the whole tree on rank 0.

    The audio family's batches carry the frontend stub's encoder frames
    with the stream's tokens (:func:`frontend_embeds`: its encoder has no
    other input; the reference's Trainer feeds none, so it cannot train
    that family).  The vlm trains on the stream's tokens alone, as the
    reference's Trainer does, in one process and on a grid."""

    def __init__(self, model_cfg, run_cfg: TrainRunConfig, comm=None, *,
                 device="cuda", grid=None):
        self.model_cfg = model_cfg
        self.run_cfg = run_cfg
        self.comm = comm
        if grid is not None and not (isinstance(comm, GridComm)
                                     and comm.grid == as_grid(grid)):
            raise ValueError(f"a Trainer on the grid {grid} takes the "
                             "rank's GridComm on it (SolverWorld.run_grid)")
        self.grid = comm.grid if isinstance(comm, GridComm) else None
        if self.grid is not None:
            api.check_grid_family(model_cfg, self.grid)
        self.device = (comm.device if comm is not None
                       else check_device(device))
        self.lead = comm is None or comm.rank == 0
        self.expert_shard = (None if self.grid is not None
                             else expert_shard_of(model_cfg, comm))
        self.opt_cfg = AdamWConfig(
            lr=cosine_warmup(run_cfg.lr, run_cfg.warmup, run_cfg.steps))
        self.stream = TokenStream(model_cfg.vocab, run_cfg.seq_len,
                                  run_cfg.global_batch, seed=run_cfg.seed)
        self.ckpt = (CheckpointManager(run_cfg.ckpt_dir, keep=run_cfg.keep)
                     if run_cfg.ckpt_dir else None)
        self._step = make_train_step(model_cfg, self.opt_cfg,
                                     run_cfg.microbatches, comm)
        self.state = self._init_or_restore()

    def _fresh_state(self) -> TrainState:
        gen = torch.Generator(device=self.device).manual_seed(
            self.run_cfg.seed)
        if self.grid is not None:
            return place_fresh(init_params(api.param_specs(self.model_cfg),
                                           gen, self.device),
                               self.model_cfg, self.comm)
        params = api.init_shard(api.param_specs(self.model_cfg), gen,
                                self.device, self.model_cfg,
                                self.expert_shard or (0, 1))
        return {"params": params, "opt": init_opt_state(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.device)}

    def _init_or_restore(self) -> TrainState:
        if self.ckpt:
            restored = self.ckpt.restore_latest(
                train_state_specs(self.model_cfg))
            if restored is not None:
                from .elastic import reshard_state
                state, extra, step = restored
                state = reshard_state(
                    state, self.model_cfg, self.device, self.expert_shard,
                    grid=self.grid,
                    coords=None if self.grid is None else self.comm.coords)
                self.stream.load_state_dict(extra["data"])
                self._log(f"[trainer] resumed from step {step}")
                return state
        return self._fresh_state()

    def _log(self, msg: str) -> None:
        if self.lead:
            print(msg)

    def logical_state(self) -> TrainState | None:
        """The whole state: the rank's own where no experts are sharded;
        else gathered to rank 0's host one layer of a leaf at a time
        (every rank must call it; the other ranks get ``None``); on a grid
        assembled from the ranks' blocks (:func:`gather_state`)."""
        if self.grid is not None:
            return gather_state(self.state, self.model_cfg, self.comm)
        if self.expert_shard is None:
            return self.state
        return moe.gather_experts(self.state, self.comm)

    def _save(self, step: int, block: bool = False) -> None:
        if not self.ckpt:
            return
        state = self.logical_state()
        if self.lead:
            self.ckpt.save(step, state, {"data": self.stream.state_dict()},
                           block=block)

    def run(self, steps: int | None = None) -> list[dict]:
        steps = steps or self.run_cfg.steps
        history = []
        t0 = time.time()
        start = int(self.state["step"])
        for i in range(start, steps):
            batch = next(self.stream)
            if self.model_cfg.family == "audio":
                batch.update(frontend_embeds(
                    self.model_cfg, len(batch["tokens"]),
                    self.stream.seq_len, self.run_cfg.seed, i))
            self.state, metrics = self._step(self.state, batch)
            if (i + 1) % self.run_cfg.log_every == 0 or i == start:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = i + 1
                m["wall"] = time.time() - t0
                history.append(m)
                self._log(f"[trainer] step {i+1} loss "
                          f"{m.get('loss', float('nan')):.4f} gnorm "
                          f"{m.get('grad_norm', 0):.3f} ({m['wall']:.1f}s)")
            if (i + 1) % self.run_cfg.save_every == 0:
                self._save(i + 1)
        self._save(steps, block=True)
        return history
