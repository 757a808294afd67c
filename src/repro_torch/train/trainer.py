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

The reference's ``train_step_shardings`` and ``abstract_train_state``
(``NamedSharding`` / ``ShapeDtypeStruct`` trees for its mesh) have no
twin.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.engine import all_reduce_variadic
from repro_torch.data import TokenStream
from repro_torch.data.regression import check_device
from repro_torch.models import api
from repro_torch.models.module import (ParamSpec, init_params, tree_leaves,
                                       tree_map)
from repro_torch.optim import (AdamWConfig, adamw_update, init_opt_state,
                               opt_state_specs)
from repro_torch.optim.schedules import cosine_warmup

TrainState = dict  # {"params", "opt": {"master", "m", "v"}, "step"}
F32 = torch.float32


def _leaves(tree) -> list:
    return tree_leaves(tree, is_leaf=torch.is_tensor)


# ---------------------------------------------------------------- specs ----

def train_state_specs(model_cfg) -> dict:
    pspecs = api.param_specs(model_cfg)
    return {"params": pspecs, "opt": opt_state_specs(pspecs),
            "step": ParamSpec((), (), torch.int32, init="zeros")}


# ----------------------------------------------------------- train step ----

def _rows(batch: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in batch.items()}


def _reduce_grads(grads: dict, comm) -> None:
    """Sum the gradient buffers over the ranks in place: one all-reduce
    for each dtype among them, in that dtype."""
    by_dtype: dict = {}
    for g in _leaves(grads):
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
    (module docstring); P > 1 refuses MoE configs."""
    P = 1 if comm is None else comm.size
    if microbatches < 1:
        raise ValueError(f"microbatches={microbatches} must be >= 1")
    if P > 1 and model_cfg.moe:
        raise ValueError(
            f"{model_cfg.name}: MoE training on {P} data-parallel ranks is "
            "not supported: the expert capacity and the aux loss count the "
            "tokens of one dispatch, which on a rank is its shard of the "
            "global batch, not the batch the reference's mesh dispatches; "
            "train MoE configs on one rank")

    def backward(model, mb: dict) -> dict:
        """Gradients of one microbatch into the model's buffers (summed
        over the ranks); returns its metrics."""
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
            part, _, _ = api.nll_sum(model, model_cfg,
                                     _rows(mb, comm.rank * n,
                                           (comm.rank + 1) * n))
            total = part / count.to(part)
            metrics = {"loss": total}
        total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if P > 1:
            _reduce_grads(model.grad_tree(), comm)
            loss = comm.all_reduce(metrics["loss"].reshape(1))[0]
            metrics = {"loss": loss, "ppl_log": loss}
        return metrics

    def train_step(state: TrainState, batch: dict):
        params = state["params"]
        dev = state["step"].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        model = api.build_model(model_cfg, params).trainable()
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
                for a, g in zip(_leaves(grads), _leaves(model.grad_tree())):
                    a.add_(g.to(F32) / microbatches)
        with torch.no_grad():
            _, _, om = adamw_update(params, grads, state["opt"],
                                    state["step"], opt_cfg)
        del model, grads
        state["step"] = state["step"] + 1
        return state, {**metrics, **om, "loss": metrics["loss"]}

    return train_step


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
    alone logs and writes the checkpoints; every rank restores."""

    def __init__(self, model_cfg, run_cfg: TrainRunConfig, comm=None, *,
                 device="cuda"):
        self.model_cfg = model_cfg
        self.run_cfg = run_cfg
        self.comm = comm
        self.device = (comm.device if comm is not None
                       else check_device(device))
        self.lead = comm is None or comm.rank == 0
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
        params = init_params(api.param_specs(self.model_cfg), gen,
                             self.device)
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
                state = reshard_state(state, self.model_cfg, self.device)
                self.stream.load_state_dict(extra["data"])
                self._log(f"[trainer] resumed from step {step}")
                return state
        return self._fresh_state()

    def _log(self, msg: str) -> None:
        if self.lead:
            print(msg)

    def _save(self, step: int, block: bool = False) -> None:
        if self.ckpt and self.lead:
            self.ckpt.save(step, self.state,
                           {"data": self.stream.state_dict()}, block=block)

    def run(self, steps: int | None = None) -> list[dict]:
        steps = steps or self.run_cfg.steps
        history = []
        t0 = time.time()
        start = int(self.state["step"])
        for i in range(start, steps):
            self.state, metrics = self._step(self.state, next(self.stream))
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
