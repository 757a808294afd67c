"""The dry run of every (architecture x input-shape) cell on a world of P
ranks, the twin of ``repro.launch.dryrun``: the records the roofline
analysis reads (``launch.roofline``).

The reference lowers and compiles each cell's step program on 256 / 512
abstract TPU devices and reads XLA's memory and cost analyses and the
collectives in the HLO.  Torch has no abstract lowering and no compiler
cost analysis, so the port takes its numbers from two sources:

* **the model's own shapes** (``launch.inputs``' specs on the ``meta``
  device): a rank's argument and output bytes at the production shape and
  full depth, exact, with nothing allocated -- every applicable cell gets
  them (:func:`run_cell`);
* **a real run at a cut size** (:func:`probe_cell`, the reference's cost
  probe): the step program at full width on the card, at depth period and
  2 period superblocks times r and 2 r rows a rank (r the largest power of
  two whose corner fits the card, from two sizing runs), counted by
  :class:`CostMode` (flops by ``torch.utils.flop_counter``'s formulas,
  matmul-type operations only; bytes as each aten op's inputs read and
  outputs written, views and aliases counting nothing -- XLA's "bytes
  accessed"; a remat recomputation counts, as in HLO), the rank's
  ``Comm`` record of its collectives, the allocator's peak and the step's
  time (host clock to a synchronize, after a warm-up); then extrapolated
  bilinearly to (full depth, the rank's full rows).  Flops, bytes and
  collectives are exact wherever the program is bilinear in depth and
  rows (MoE capacities round up: their error is within one capacity slot
  an expert a layer); the step time and the temp bytes are a model, and
  the record says so.

The cells are the port's own parallelism on a world of P ranks
(``core.world.SolverWorld``: gloo ranks sharing the card when there are
fewer cards than ranks, nccl with one card a rank otherwise):
data-parallel train and prefill, and decode on a sequence-sharded cache
with flash-decoding; an MoE model's experts sharded over the ranks in
every kind (E / P a rank, one global dispatch: ``models.moe``; a P that
does not divide E is skipped with its reason).  The reference's meshes ``single`` / ``multi`` become
worlds ``p{P}``.  The probe follows the reference's ``_probe_cfg``:
single-block attention (``block_q = block_kv = seq_len``), unless its
corners would not fit the card with it (prefill_32k's one-row score block
is 100 GB), where it takes square blocks of PROBE_BLOCK, whose causal
skip leaves out the fully masked key blocks; its rows start at r = 2 (a
1-row corner bends the bytes' linearity in the rows) unless only 1 and 2
rows fit.  The record names the attention and the rows it ran.

The reference's meshes themselves are grids of ranks (``--mesh single``
= ``16x16``, ``multi`` = ``2x16x16``, or any ``DxM`` / ``PxDxM``): there the
analytic record (:func:`grid_cell`) holds a rank's argument bytes under
the rule table (``launch.inputs``' grid specs: the reference's
per-device bytes), its output bytes (the logits cut over ('batch',
'vocab'), a prefill's cache under the rules) and its alias bytes; a
probe runs on the ``p{P}`` world of ``--ranks`` that fits the card, and
the grid's record names that layout (``probe_layout``) without taking its
numbers.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID|all]
        [--shape NAME|all] [--ranks P] [--mesh none|single|multi|DxM]
        [--probe] [--set k=v[,k=v]] [--tag T] [--out DIR]
        [--seq-shard-decode true|false] [--device cuda|cpu]

Per cell it writes ``<out>/<arch>__<shape>__p<P>.json`` (``__16x16`` etc.
on a grid; with ``--probe`` also ``...__p<P>__probe.json``).  A failing cell is a bug: it is
recorded and ``main`` exits non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core.collectives import _kinds, tensors
from repro_torch.data.regression import check_device
from repro_torch.launch import inputs as I
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.models.module import tree_leaves
from repro_torch.core.grid import as_grid, grid_name, grid_size
from repro_torch.core.world import sync_device
from repro_torch.models.sharding import make_rules, shard_shape
from repro_torch.optim import AdamWConfig
from repro_torch.train.trainer import make_train_step

SINGLE_BLOCK_BYTES = 16e9   # largest one-row score block the probe runs
PROBE_MEMORY_SHARE = 0.8    # of the card's free memory, split over its ranks
# The probe's rows double past r0 only while a corner's 2 r rows hold at
# most this many tokens, which bounds a cell's runs to seconds (train and
# prefill keep r0; decode's one token a row grows to what fits)
PROBE_TOKENS = 16384
# Where single-block attention would not fit, the probe's blocks: square,
# at most this long (fewer eager block steps than the configs' 512 x 1024)
PROBE_BLOCK = 2048
PRODUCTION_CHIPS = (256, 512)   # the reference's meshes


# ---------------------------------------------------------------- counting --

# Ops that only read metadata, and ops whose output shares its input's
# storage without being marked a view in its schema.
_UNCOUNTED = {torch.ops.aten._unsafe_view.default,
              torch.ops.aten.lift_fresh.default}
# In-place ops that write their target without reading it.
_WRITE_ONLY = {"copy_", "fill_", "zero_", "uniform_", "normal_"}
# Ops that write a few elements of their target: (name, values argument).
_SPARSE_WRITES = {"index_put_": 2, "_index_put_impl_": 2, "index_add_": 3,
                  "index_copy_": 3, "scatter_": 3, "scatter_add_": 3,
                  "masked_scatter_": 2}


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` addresses, a broadcast (stride-0)
    dimension read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts the aten ops run under it (both passes of a backward, on any
    thread the mode reaches): ``flops`` by ``torch.utils.flop_counter``'s
    formulas (mm, addmm, bmm, baddbmm, convolutions, attention kernels;
    elementwise work counts no flops), ``bytes`` as every tensor input read
    once and every output written once.  Views and aliases count nothing,
    nor do collectives (``Comm`` records those); an in-place op reads its
    target unless it only writes it (``copy_``, ``fill_``, ``zero_``), and
    an indexed write (``index_put_``, ``index_add_``, ``scatter_``) writes
    its values' bytes, not its target's."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (func.is_view or func in _UNCOUNTED
                or func.namespace not in ("aten", "prims")):
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        self.bytes += self._bytes(func, args, kwargs, out)
        return out

    @staticmethod
    def _bytes(func, args, kwargs, out) -> int:
        schema = func._schema
        written = {i for i, a in enumerate(schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write}
        name = func._overloadpacket.__name__
        read = 0
        for i, a in enumerate(args):
            if i in written and (name in _WRITE_ONLY
                                 or name in _SPARSE_WRITES):
                continue
            read += sum(_nbytes(t) for t in tensors(a))
        read += sum(_nbytes(t) for t in tensors(list(kwargs.values())))
        if name in _SPARSE_WRITES:
            values = args[_SPARSE_WRITES[name]]
            return read + sum(_nbytes(t) for t in tensors(values))
        return read + sum(_nbytes(t) for t in tensors(out))


# ------------------------------------------------------------ the programs --

def _cell_program(cfg, shape, n_ranks: int = 1, seq_shard_decode=True, *,
                  rows: int | None = None, comm=None):
    """(step, spec args) of one rank's step program in the cell:
    ``step(*args)`` runs it on the operands :func:`_operands` makes of the
    specs.  ``rows`` overrides the rank's rows (the probe's cut)."""
    wire = comm if n_ranks > 1 else None
    if shape.kind == "train":
        state, batch = I.train_specs(cfg, shape, n_ranks, rows)
        step = make_train_step(cfg, AdamWConfig(lr=1e-4), microbatches=1,
                               comm=wire)
        return step, (state, batch)
    if shape.kind == "prefill":
        params, batch = I.prefill_specs(cfg, shape, n_ranks, rows)

        def prefill_fn(model, b):
            return api.prefill(model, cfg, b, max_seq=shape.seq_len,
                               comm=wire)

        return prefill_fn, (params, batch)
    params, cache, tok, pos = I.decode_specs(cfg, shape, n_ranks,
                                             seq_shard=seq_shard_decode,
                                             rows=rows)

    def serve_step(model, c, t, q):
        return api.decode_step(model, cfg, c, t, q,
                               comm=wire if seq_shard_decode else None,
                               expert_comm=wire)

    return serve_step, (params, cache, tok, pos)


def _operands(cfg, shape, specs: tuple, n_ranks: int, device,
              generator: torch.Generator) -> tuple:
    """Real operands of :func:`_cell_program`'s specs on ``device``
    (``inputs.materialize``): the parameters built into the model; a train
    state whose master is its parameters in f32 and whose moments and step
    start at zero; a data-parallel train rank's rows tiled to the global
    batch that ``make_train_step`` cuts its rows from; decode at the last
    position of the cache (``seq_len - 1``) on every row."""
    vocab = cfg.vocab
    if shape.kind == "train":
        state, batch = (I.materialize(t, device, generator, high=vocab)
                        for t in specs)
        opt = state["opt"]
        for p, mst, m, v in zip(*(tree_leaves(t, is_leaf=torch.is_tensor)
                                  for t in (state["params"], opt["master"],
                                            opt["m"], opt["v"]))):
            mst.copy_(p)
            m.zero_()
            v.zero_()
        state["step"].zero_()
        batch["mask"].fill_(1.0)
        if n_ranks > 1:
            batch = {k: torch.cat([v] * n_ranks) for k, v in batch.items()}
        return state, batch
    params = I.materialize(specs[0], device, generator, high=vocab)
    model = api.build_model(cfg, params)
    rest = [I.materialize(t, device, generator, high=vocab)
            for t in specs[1:]]
    if shape.kind == "decode":
        rest[-1].fill_(shape.seq_len - 1)
    return (model, *rest)


def _output_bytes(cfg, shape, n_ranks: int, seq_shard: bool,
                  rows: int | None = None) -> tuple[int, int]:
    """(bytes of the new buffers the rank's step returns, bytes it updates
    in place): the updated train state and decode cache are aliases, as
    XLA reports a donated buffer."""
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    if shape.kind == "train":
        state, _ = I.train_specs(cfg, shape, n_ranks, rows)
        metrics = 4 + (1 if cfg.moe else 0)
        return 4 * metrics, I.tree_bytes(state)
    B = (I.rank_rows(shape.global_batch, n_ranks) if shape.kind == "prefill"
         else shape.global_batch) if rows is None else rows
    logits = B * cfg.padded_vocab * itemsize
    if shape.kind == "prefill":
        cache = api.init_cache_specs(cfg, B, shape.seq_len)
        return logits + I.tree_bytes(I._from_specs(cache)), 0
    _, cache, _, _ = I.decode_specs(cfg, shape, n_ranks, seq_shard=seq_shard,
                                    rows=B)
    return logits, I.tree_bytes(cache)


def _rank_corner(comm, device, *, cfg, shape, rows: int, size: int,
                 seq_shard: bool, seed: int, timed: bool) -> dict:
    """One probe corner on one rank of ``size``: a counted run (the
    warm-up), with the allocator's peak on CUDA, and with ``timed`` a
    second, timed run on CUDA."""
    n_ranks = size
    device = torch.device(device)
    cuda = device.type == "cuda"
    pre = torch.cuda.memory_allocated(device) if cuda else 0
    gen = torch.Generator(device=device).manual_seed(seed)
    step, specs = _cell_program(cfg, shape, n_ranks, seq_shard, rows=rows,
                                comm=comm)
    args = _operands(cfg, shape, specs, n_ranks, device, gen)
    grad = (contextlib.nullcontext if shape.kind == "train"
            else torch.no_grad)
    if comm is not None:
        comm.reset()
    sync_device(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    mode = CostMode()
    with mode, grad():
        out = step(*args)
    sync_device(device)
    rec = {"flops": mode.flops, "bytes": mode.bytes,
           "counters": None if comm is None else comm.counters(),
           "peak": None, "temp": None, "step_s": None}
    if cuda:
        peak = torch.cuda.max_memory_allocated(device)
        rec.update(peak=peak - pre, temp=peak - base)
    del out
    if timed and cuda:      # a CPU run's time is no device metric
        with grad():
            sync_device(device)
            t0 = time.perf_counter()
            out = step(*args)
            sync_device(device)
            rec["step_s"] = time.perf_counter() - t0
        del out
    del args
    if cuda:
        torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------- records --

def _apply_overrides(cfg, overrides: dict):
    overrides = dict(overrides)
    moe_keys = overrides.pop("__moe__", None)
    if moe_keys and cfg.moe:
        overrides["moe"] = dataclasses.replace(cfg.moe, **moe_keys)
    return dataclasses.replace(cfg, **overrides)


def _parse_set(spec: str | None) -> dict | None:
    """--set k=v[,k=v]: ints, with moe_* keys routed into the MoE config."""
    if not spec:
        return None
    out = {}
    for kv in spec.split(","):
        k, v = kv.split("=")
        out[k] = int(v)
    moe_keys = {k[4:]: v for k, v in out.items() if k.startswith("moe_")}
    out = {k: v for k, v in out.items() if not k.startswith("moe_")}
    if moe_keys:
        out["__moe__"] = moe_keys
    return out


def _single_block(cfg, shape) -> bool:
    """The reference's single-block attention, where one row's score block
    (s, its mask and its exponent in f32) fits SINGLE_BLOCK_BYTES."""
    return 12 * cfg.resolved_q_heads * shape.seq_len ** 2 <= \
        SINGLE_BLOCK_BYTES


def _probe_cfg(cfg, depth: int, period: int, shape, *,
               single_block: bool = True):
    """Full width, ``depth`` layers (and encoder layers for the audio
    family), single-block attention when ``single_block`` (the
    reference's ``_probe_cfg``; the port has no loop to unroll), else
    square blocks of at most PROBE_BLOCK."""
    block = shape.seq_len if single_block else min(shape.seq_len,
                                                   PROBE_BLOCK)
    kw = dict(n_layers=depth, block_q=block, block_kv=block)
    if cfg.family == "audio":
        kw["enc_layers"] = depth
    return dataclasses.replace(cfg, **kw)


def _share(shape, n_ranks: int) -> int:
    """A rank's rows of the cell: its data-parallel rows, or the whole
    batch for decode."""
    if shape.kind == "decode":
        return shape.global_batch
    return I.rank_rows(shape.global_batch, n_ranks)


@functools.lru_cache(maxsize=None)
def _smi() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _card(device) -> dict:
    """The card's name, power limit and memory (``None`` on the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": "cpu", "smi": None, "total_memory": None}
    props = torch.cuda.get_device_properties(device)
    return {"device": torch.cuda.get_device_name(device), "smi": _smi(),
            "total_memory": props.total_memory}


def run_cell(arch: str, shape_name: str, n_ranks: int, out_dir: str,
             seq_shard_decode: bool = True, verbose: bool = True,
             overrides: dict | None = None, tag: str = "", *,
             device="cuda", probe: dict | None = None) -> dict:
    """The analytic record of a cell: a rank's argument, output and alias
    bytes at the production shape and full depth from the meta specs;
    with the cell's ``probe`` record, its extrapolated temp bytes, flops,
    bytes and collectives (else ``None``: not measured)."""
    cfg = get_config(arch)
    if overrides:
        cfg = _apply_overrides(cfg, overrides)
    shape = SHAPES[shape_name]
    ok, why = shape.applicable(cfg)
    rec = {"arch": cfg.name + tag, "shape": shape_name,
           "mesh": f"p{n_ranks}", "kind": shape.kind}
    if ok:
        ok, why = _experts_split(cfg, n_ranks)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        _write(rec, out_dir)
        return rec
    try:
        _, specs = _cell_program(cfg, shape, n_ranks, seq_shard_decode)
        out_bytes, alias = _output_bytes(cfg, shape, n_ranks,
                                         seq_shard_decode)
        card = _card(device)
        ex = (probe or {}).get("extrapolated_per_device") \
            if (probe or {}).get("status") == "ok" else None
        args = I.tree_bytes(specs)
        temp = None if ex is None else ex["temp_bytes"]
        rec.update({
            "status": "ok", "chips": n_ranks, "ranks": n_ranks,
            "memory_analysis": {
                "argument_bytes": args, "output_bytes": out_bytes,
                "alias_bytes": alias, "temp_bytes": temp,
                "device_memory_bytes": card["total_memory"],
                "temp_source": ("the probe's allocator peak, extrapolated "
                                "(a model)" if temp is not None
                                else "not measured"),
            },
            "cost_analysis": None if ex is None else {
                "flops_per_device": ex["flops"],
                "bytes_accessed_per_device": ex["bytes_accessed"],
                "source": "probe-extrapolated"},
            "collectives": None if ex is None else {
                "count": ex["coll_count"],
                "operand_bytes": ex["coll_operand_bytes"],
                "link_bytes": ex["coll_link_bytes"],
                "by_kind": ex["by_kind"]},
            "wire": (probe or {}).get("wire", "one rank: no wire"
                                      if n_ranks == 1 else "not run"),
            "timings": {"step_ms": None if ex is None or ex["step_s"] is None
                        else ex["step_s"] * 1e3,
                        "card": card["smi"] or card["device"]},
            "reduced": {"ranks": f"{n_ranks} of the reference's "
                                 f"{PRODUCTION_CHIPS} chips",
                        **_experts_cut(cfg, n_ranks)},
        })
        if verbose:
            print(f"[dryrun] {rec['arch']} {shape_name} p{n_ranks}: "
                  f"arguments {args / 1e9:.3f} GB, outputs "
                  f"{out_bytes / 1e9:.3f} GB a rank", flush=True)
    except Exception as e:  # a failing cell is a bug; record, fail at the end
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    _write(rec, out_dir)
    return rec


def _grid_output_bytes(cfg, shape, grid: dict, seq_shard: bool) -> tuple:
    """(new bytes, alias bytes) a rank's step returns on ``grid``: the
    train state updated in place and the metrics; the logits cut over
    ('batch', 'vocab') and a prefill's new cache, or a decode step's
    cache updated in place, under the rules."""
    if shape.kind == "train":
        state, _ = I.train_specs(cfg, shape, grid=grid)
        return 4 * (4 + (1 if cfg.moe else 0)), I.tree_bytes(state)
    rules = make_rules(grid, fsdp=cfg.fsdp)
    B, V = shape.global_batch, cfg.padded_vocab
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    logits = (math.prod(shard_shape((B, V), rules.spec_for(
        (B, V), ("batch", "vocab")), grid)) * itemsize)
    if shape.kind == "prefill":
        cache = I._grid_cut(api.init_cache_specs(cfg, B, shape.seq_len),
                            rules)
        return logits + I.tree_bytes(cache), 0
    _, cache, _, _ = I.decode_specs(cfg, shape, seq_shard=seq_shard,
                                    grid=grid)
    return logits, I.tree_bytes(cache)


def grid_cell(arch: str, shape_name: str, grid, out_dir: str,
              seq_shard_decode: bool = True, verbose: bool = True,
              overrides: dict | None = None, tag: str = "", *,
              device="cuda", probe_ranks: int | None = None) -> dict:
    """The analytic record of a cell on a grid of ranks (the reference's
    mesh): a rank's argument, output and alias bytes under the rule table
    at the production shape and full depth, from the meta specs.  No
    temp bytes, flops or collectives: the probe runs on the ``p{P}``
    world of ``probe_ranks`` (named in ``probe_layout``), not on this
    grid."""
    grid = as_grid(grid)
    cfg = get_config(arch)
    if overrides:
        cfg = _apply_overrides(cfg, overrides)
    shape = SHAPES[shape_name]
    ok, why = shape.applicable(cfg)
    rec = {"arch": cfg.name + tag, "shape": shape_name,
           "mesh": grid_name(grid), "kind": shape.kind}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        _write(rec, out_dir)
        return rec
    try:
        if shape.kind == "train":
            specs = I.train_specs(cfg, shape, grid=grid)
        elif shape.kind == "prefill":
            specs = I.prefill_specs(cfg, shape, grid=grid)
        else:
            specs = I.decode_specs(cfg, shape, seq_shard=seq_shard_decode,
                                   grid=grid)
        args = I.tree_bytes(specs)
        out_bytes, alias = _grid_output_bytes(cfg, shape, grid,
                                              seq_shard_decode)
        card = _card(device)
        rules = make_rules(grid, fsdp=cfg.fsdp)
        rules.tree(api.param_specs(cfg))
        rec.update({
            "status": "ok", "chips": grid_size(grid), "grid": grid,
            "memory_analysis": {
                "argument_bytes": args, "output_bytes": out_bytes,
                "alias_bytes": alias, "temp_bytes": None,
                "device_memory_bytes": card["total_memory"],
                "temp_source": "not measured (no probe on this grid)"},
            "cost_analysis": None, "collectives": None,
            "dropped": sorted({f"{d[0]} {d[1]} over {'x'.join(d[2])}"
                               for d in rules.dropped}),
            "probe_layout": (None if probe_ranks is None
                             else f"p{probe_ranks}"),
            "timings": {"step_ms": None,
                        "card": card["smi"] or card["device"]},
            "reduced": {"ranks": f"the reference's {grid_name(grid)} mesh "
                                 "as a grid of ranks, analytic (meta "
                                 "specs, no run)"},
        })
        if verbose:
            print(f"[dryrun] {rec['arch']} {shape_name} {rec['mesh']}: "
                  f"arguments {args / 1e9:.3f} GB, outputs "
                  f"{out_bytes / 1e9:.3f} GB a rank", flush=True)
    except Exception as e:  # a failing cell is a bug; record, fail at the end
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    _write(rec, out_dir)
    return rec


def _kind_bytes(c: dict) -> dict:
    return {"max": c["max_bytes"], "hop": c["hop_bytes"],
            "all_to_all": c["a2a_bytes"], "all_gather": c["gather_bytes"],
            "reduce_scatter": c["rs_bytes"],
            "all_reduce": c["bytes"] - c["max_bytes"] - c["hop_bytes"]
            - c["a2a_bytes"] - c["gather_bytes"] - c["rs_bytes"]}


def _combine(outs: list, routed: bool = False) -> dict:
    """The ranks' records of one corner: rank 0's counts (every rank's
    must match), the slowest rank's time and the largest peak.  With
    ``routed`` (an MoE model's experts sharded over the ranks) the rows a
    rank sends and its experts receive follow the routing, so its bytes,
    all-to-all bytes and every kind's operand bytes are the largest
    rank's; the flops and each kind's calls must still match."""
    first = outs[0]
    for r, o in enumerate(outs[1:], 1):
        same = (o["flops"] == first["flops"]
                and (routed or o["bytes"] == first["bytes"]))
        if not same:
            raise RuntimeError(
                f"rank {r} counted {o['flops']} flops / {o['bytes']} bytes, "
                f"rank 0 {first['flops']} / {first['bytes']}")
    c = first["counters"]
    kinds = {} if c is None else _kinds(c)
    counters = [o["counters"] for o in outs if o["counters"] is not None]
    for r, o in enumerate(counters[1:], 1):
        if {k: n for k, (n, _) in _kinds(o).items()} != \
                {k: n for k, (n, _) in kinds.items()}:
            raise RuntimeError(f"rank {r} made other collectives than rank "
                               f"0: {_kinds(o)} / {kinds}")
    kind_bytes = {k: max(_kind_bytes(o)[k] for o in counters)
                  for k in _kind_bytes(c)} if c is not None else {}

    def most(key):
        vals = [o[key] for o in outs]
        return None if None in vals else max(vals)

    return {"flops": first["flops"], "bytes": most("bytes"),
            "coll_count": sum(n for n, _ in kinds.values()),
            "coll_operand": (0 if c is None
                             else max(o["bytes"] for o in counters)),
            "by_kind": {k: {"count": n, "operand_bytes": kind_bytes[k]}
                        for k, (n, _) in kinds.items()},
            "step_s": most("step_s"), "peak": most("peak"),
            "temp": most("temp")}


def _bilinear(f: dict, K: float, R: float, r: int, rows2: bool) -> float:
    """f at (K blocks, R rows) from the corners ``f[(k, j)]``, k in {1, 2}
    blocks, j in {1, 2} for rows r and 2 r (j = 1 only when ``rows2`` is
    False: the rank has one row)."""
    dk = K - 1
    base = f[(1, 1)] + dk * (f[(2, 1)] - f[(1, 1)])
    if not rows2:
        return base
    dr = (R - r) / r
    return (base + dr * (f[(1, 2)] - f[(1, 1)])
            + dk * dr * (f[(2, 2)] - f[(2, 1)] - f[(1, 2)] + f[(1, 1)]))


def probe_cell(arch: str, shape_name: str, n_ranks: int, out_dir: str,
               seq_shard_decode: bool = True, overrides: dict | None = None,
               tag: str = "", *, device="cuda", world=None,
               seed: int = 0) -> dict:
    """The cost probe (module docstring): corners at depth {period, 2
    period} x rows {r, 2 r} at full width, counted and timed on ``device``
    (one rank) or on the first ``n_ranks`` ranks of ``world``, extrapolated
    bilinearly to the full depth and the rank's full rows (r: the largest
    that fits the card, :func:`_rows_that_fit`; its start r0 on the CPU).
    A probe whose smallest corner cannot fit the card is ``skipped`` with
    the GB in its reason."""
    cfg = get_config(arch)
    if overrides:
        cfg = _apply_overrides(cfg, overrides)
    shape = SHAPES[shape_name]
    rec = {"arch": cfg.name + tag, "shape": shape_name,
           "mesh": f"p{n_ranks}", "kind": shape.kind, "probe": True}
    ok, why = shape.applicable(cfg)
    if ok:
        ok, why = _experts_split(cfg, n_ranks)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        _write(rec, out_dir, suffix="__probe")
        return rec
    period = api._superblock_period(cfg)
    blocks = cfg.n_layers // period
    share = _share(shape, n_ranks)
    card = _card(device)
    try:
        budget = _budget(device, n_ranks, world)
        rows2 = share >= 2
        plan = _probe_plan(cfg, shape, period, n_ranks, seq_shard_decode,
                           budget, share)
        if plan is None:
            need = _corner_need(cfg, shape, 2 * period, period, n_ranks,
                                seq_shard_decode, False,
                                2 if rows2 else 1)
            sb = (_param_bytes(cfg, 2 * period, n_ranks)
                  - _param_bytes(cfg, period, n_ranks))
            rec["status"] = "skipped"
            rec["reason"] = (
                f"the probe's smallest corner ({2 * period} layers, "
                f"{2 if rows2 else 1} rows, chunked attention) needs about "
                f"{need / 1e9:.1f} GB (operands, gradients and the logits' "
                f"and scores' buffers; a superblock of {period} layers holds "
                f"{sb / 1e9:.1f} GB of parameters), over the "
                f"{budget / 1e9:.1f} GB a rank has on this card")
            _write(rec, out_dir, suffix="__probe")
            return rec
        single, r0 = plan

        def corner(depth: int, nrows: int, timed: bool) -> dict:
            kw = dict(cfg=_probe_cfg(cfg, depth, period, shape,
                                     single_block=single),
                      shape=shape, rows=nrows, size=n_ranks,
                      seq_shard=seq_shard_decode, seed=seed, timed=timed)
            if world is None:
                outs = [_rank_corner(None, device, **kw)]
            else:
                outs = world.run(_rank_corner, n_ranks, **kw)
            return _combine(outs, bool(cfg.moe) and n_ranks > 1)

        tokens = 1 if shape.kind == "decode" else shape.seq_len
        sizing = {}
        if budget is not None and rows2 and _may_grow(r0, share, tokens):
            sizing = {j: corner(2 * period, j * r0, False) for j in (1, 2)}
        r = _rows_that_fit(sizing, budget, share, r0, tokens)
        pts = {}
        for k in (1, 2):
            for j in ((1, 2) if rows2 else (1,)):
                pts[(k, j)] = corner(k * period, j * r, timed=True)
        K, R = blocks, share

        def ex(key):
            f = {c: p[key] for c, p in pts.items()}
            if any(v is None for v in f.values()):
                return None
            return max(_bilinear(f, K, R, r, rows2), 0.0)

        # a time that does not grow with depth and rows (a host-bound cut)
        # extrapolates to nothing: not measured
        step_s = ex("step_s") or None

        link = 2 * (n_ranks - 1) / n_ranks
        by_kind = {}
        for kind in sorted({k for p in pts.values() for k in p["by_kind"]}):
            f = {c: p["by_kind"].get(kind, {"count": 0, "operand_bytes": 0})
                 for c, p in pts.items()}
            cnt = _bilinear({c: v["count"] for c, v in f.items()}, K, R, r,
                            rows2)
            opnd = _bilinear({c: v["operand_bytes"] for c, v in f.items()},
                             K, R, r, rows2)
            by_kind[kind] = {"count": cnt, "operand_bytes": opnd,
                             "link_bytes": link * opnd}
        flops_blk = (_bilinear({c: p["flops"] for c, p in pts.items()}, 2, R,
                               r, rows2)
                     - _bilinear({c: p["flops"] for c, p in pts.items()}, 1,
                                 R, r, rows2))
        opnd = ex("coll_operand")
        out_bytes, _ = _output_bytes(cfg, shape, n_ranks, seq_shard_decode)
        temp = ex("temp")
        check = (_rows_check(sizing, pts, r, r0)
                 if r > r0 and len(sizing) == 2 else None)
        rec.update({
            "status": "ok", "chips": n_ranks, "ranks": n_ranks,
            "attention": ("decode attention" if shape.kind == "decode"
                          else "single-block" if single else
                          f"chunked ({min(shape.seq_len, PROBE_BLOCK)}-"
                          "square blocks; fully masked causal key blocks "
                          "skipped)"),
            "wire": _wire_name(world, n_ranks),
            "rows": {"probe": [r, 2 * r] if rows2 else [r], "full": R,
                     "sizing_from": r0},
            "depths": [period, 2 * period],
            "points": [{"blocks": k, "rows": j * r,
                        **{key: p[key] for key in (
                            "flops", "bytes", "coll_count", "coll_operand",
                            "step_s", "peak", "temp")}}
                       for (k, j), p in sorted(pts.items())],
            "sizing": {j: {"peak_bytes": p["peak"]}
                       for j, p in sizing.items()},
            "rows_linearity_check": check,
            "moe_capacity_slots": _capacity_slots(cfg, shape, r, R, rows2,
                                                  n_ranks),
            "extrapolated_per_device": {
                "flops": ex("flops"), "bytes_accessed": ex("bytes"),
                "coll_count": ex("coll_count"),
                "coll_operand_bytes": opnd,
                "coll_link_bytes": None if opnd is None else link * opnd,
                "by_kind": by_kind,
                "flops_per_block": flops_blk,
                "flops_base": _bilinear({c: p["flops"]
                                         for c, p in pts.items()}, 1, R, r,
                                        rows2) - flops_blk,
                "step_s": step_s,
                "temp_bytes": None if temp is None
                else max(temp - out_bytes, 0.0),
            },
            "model": ("flops, bytes and collectives exact where the program "
                      "is bilinear in depth and rows"
                      + (" (MoE capacities round up a slot at a time)"
                         if cfg.moe else "")
                      + "; step_s and temp_bytes a bilinear model of "
                      "measured times and allocator peaks"
                      + ("" if card["total_memory"] else
                         " (not measured on the CPU)")),
            "timings": {"card": card["smi"] or card["device"]},
            "reduced": {
                "rows": f"{[r, 2 * r] if rows2 else [r]} of the rank's {R}",
                "depth": f"{[period, 2 * period]} of {cfg.n_layers} layers",
                "ranks": f"{n_ranks} of the reference's {PRODUCTION_CHIPS} "
                         "chips", **_experts_cut(cfg, n_ranks)},
        })
    except Exception as e:
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    _write(rec, out_dir, suffix="__probe")
    return rec


def _wire_name(world, n_ranks: int) -> str:
    if n_ranks == 1 or world is None:
        return "one rank: no wire"
    if world.backend == "gloo" and world.device.type == "cuda":
        return (f"{n_ranks} gloo ranks sharing one card (host-staged), not "
                "NVLink")
    if world.backend == "gloo":
        return f"{n_ranks} gloo ranks on the CPU"
    return f"{n_ranks} nccl ranks, one card each"


def _budget(device, n_ranks: int, world) -> float | None:
    """Bytes a rank may fill: PROBE_MEMORY_SHARE of the card's free memory,
    split over the ranks that share it (``None`` on the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(device)
    shared = n_ranks if world is not None and world.backend == "gloo" else 1
    return PROBE_MEMORY_SHARE * free / shared


def _probe_plan(cfg, shape, period: int, n_ranks: int, seq_shard: bool,
                budget: float | None, share: int) -> tuple | None:
    """(single-block attention, the rows r0 the sizing starts from) of the
    first plan whose largest sizing corner fits ``budget``, in the order:
    the reference's single-block attention before PROBE_BLOCK chunks, and
    r0 = 2 before 1 (rows start at 2 where the rank has 4 and a row holds
    at most PROBE_TOKENS tokens: a 1-row tensor is contiguous in layouts
    that copy at 2 rows and more, so a 1-row corner bends the bytes'
    linearity in the rows; prefill_32k's rows start at 1 to bound its
    runs); ``None`` when none fits."""
    single_ok = _single_block(cfg, shape) and shape.kind != "decode"
    tokens = 1 if shape.kind == "decode" else shape.seq_len
    r0s = (2, 1) if share >= 4 and tokens <= PROBE_TOKENS else (1,)
    for single in ((True, False) if single_ok else (False,)):
        for r0 in r0s:
            rows = 2 * r0 if share >= 2 else r0
            need = _corner_need(cfg, shape, 2 * period, period, n_ranks,
                                seq_shard, single, rows)
            if budget is None or need <= budget:
                return single, r0
    return None


def _param_bytes(cfg, depth: int, n_ranks: int = 1) -> int:
    """A rank's parameter bytes at ``depth`` layers (its experts' shard on
    ``n_ranks`` ranks)."""
    pcfg = dataclasses.replace(cfg, n_layers=depth, **(
        {"enc_layers": depth} if cfg.family == "audio" else {}))
    return I.tree_bytes(I._params(pcfg, n_ranks))


def _experts_split(cfg, n_ranks: int) -> tuple[bool, str | None]:
    """Can an MoE model's experts be sharded over ``n_ranks``?"""
    if cfg.moe and cfg.moe.num_experts % n_ranks:
        return False, (f"{cfg.moe.num_experts} experts do not split over "
                       f"{n_ranks} ranks (experts are sharded, E % P == 0)")
    return True, None


def _experts_cut(cfg, n_ranks: int) -> dict:
    """The ``reduced`` entry of a rank's expert shard."""
    if not cfg.moe or n_ranks == 1:
        return {}
    E = cfg.moe.num_experts
    return {"experts": f"{E // n_ranks} of {E} a rank (experts sharded over "
                       f"the {n_ranks} ranks; the reference's 'model' axis)"}


def _corner_need(cfg, shape, depth: int, period: int, n_ranks: int,
                 seq_shard: bool, single: bool, rows: int) -> float:
    """An estimate of a corner's footprint in bytes, before a run can
    measure it: the operands, a train step's gradients and the buffers of
    its logits' loss (bf16 logits, their f32 copy, exponent and gradient),
    and the single-block scores (about three f32 copies of a layer's
    (H, S, S) a row, five in a train step's backward)."""
    pcfg = _probe_cfg(cfg, depth, period, shape, single_block=single)
    _, specs = _cell_program(pcfg, shape, n_ranks, seq_shard, rows=rows)
    need = I.tree_bytes(specs)
    if shape.kind == "train":
        need += _param_bytes(cfg, depth, n_ranks)
        need += rows * shape.seq_len * cfg.padded_vocab * 14
    copies = 5 if shape.kind == "train" else 3
    need += 4 * copies * cfg.resolved_q_heads * pcfg.block_q \
        * pcfg.block_kv * rows
    if cfg.moe:     # a layer's dispatch buffers (models.moe._dispatch)
        from repro_torch.models.moe import _capacity
        m = cfg.moe
        T = rows * (1 if shape.kind == "decode" else shape.seq_len)
        C = _capacity(T, m.top_k, m.num_experts, m.capacity_factor)
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        need += (m.num_experts * C * (2 * cfg.d_model + 3 * cfg.d_ff)
                 * itemsize + T * m.top_k * cfg.d_model * (itemsize + 4)
                 + 8 * T * cfg.d_model)
    return need


def _may_grow(r: int, share: int, tokens: int) -> bool:
    """May the probe's rows double from r: 2 (2 r) rows within the rank's
    and within PROBE_TOKENS tokens?"""
    return 4 * r <= share and 4 * r * tokens <= PROBE_TOKENS


def _rows_that_fit(sizing: dict, budget: float | None, share: int,
                   r0: int, tokens: int) -> int:
    """The largest r = r0 2^i (:func:`_may_grow`) whose 2 r-row corner fits
    ``budget``, by the allocator's peaks at r0 and 2 r0 rows (affine in
    the rows); r0 without sizing runs (on the CPU, or where r0 may not
    grow)."""
    if budget is None or len(sizing) < 2:
        return r0
    per_row = max((sizing[2]["peak"] - sizing[1]["peak"]) / r0, 1)
    fixed = sizing[1]["peak"] - r0 * per_row
    r = r0
    while _may_grow(r, share, tokens) and \
            fixed + 4 * r * per_row <= budget:
        r *= 2
    return r


def _rows_check(sizing: dict, pts: dict, r: int, r0: int) -> dict:
    """The sizing runs (2 period layers at r0 and 2 r0 rows) extrapolated
    linearly in the rows to the corners at r and 2 r of the same depth,
    against their counts: relative deviation of flops and bytes."""
    out = {}
    for key in ("flops", "bytes"):
        a, b = sizing[1][key], sizing[2][key]
        devs = []
        for j in (1, 2):
            want = pts[(2, j)][key]
            got = a + (b - a) * (j * r - r0) / r0
            devs.append(abs(got - want) / max(abs(want), 1))
        out[key] = max(devs)
    return out


def _capacity_slots(cfg, shape, r: int, R: int, rows2: bool,
                    n_ranks: int = 1) -> dict | None:
    """An MoE layer's expert capacity at the full rows, exact against the
    probe's linear extrapolation from r and 2 r rows (each expert's flops
    and bytes scale with its slots: the difference is the extrapolation's
    error, per expert and MoE layer).  A data-parallel rank's rows
    dispatch with every rank's (the capacity of P r rows)."""
    if not cfg.moe:
        return None
    from repro_torch.models.moe import _capacity
    m = cfg.moe
    per_row = (1 if shape.kind == "decode" else shape.seq_len * n_ranks)

    def cap(rows):
        return _capacity(rows * per_row, m.top_k, m.num_experts,
                         m.capacity_factor)
    lin = cap(r) if not rows2 else cap(r) + (cap(2 * r) - cap(r)) * (R - r) / r
    return {"exact": cap(R), "extrapolated": lin}


def _write(rec: dict, out_dir: str, suffix: str = "") -> None:
    os.makedirs(out_dir, exist_ok=True)
    name = (f"{rec['arch'].replace('/', '_')}__{rec['shape']}"
            f"__{rec['mesh']}{suffix}.json")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def open_world(n_ranks: int, device):
    """The probe's world of ``n_ranks`` ranks (``None`` for one): nccl with
    a card a rank when the host has them, gloo ranks sharing the card (or
    the CPU) otherwise."""
    if n_ranks == 1:
        return None
    from repro_torch.core import SolverWorld
    device = torch.device(device)
    backend = ("nccl" if device.type == "cuda"
               and torch.cuda.device_count() >= n_ranks else "gloo")
    return SolverWorld(n_ranks, backend=backend, device=device,
                       kernels=False)


def run(archs, shapes, n_ranks: int = 1, out_dir: str = "artifacts/dryrun",
        *, probe: bool = True, seq_shard: bool = True, overrides=None,
        tag: str = "", device="cuda", world=None, seed: int = 0,
        grid=None) -> list:
    """Every (arch, shape) cell on ``n_ranks`` ranks: the probe (with
    ``probe``) and the analytic record, which takes the probe's
    extrapolation.  With ``grid`` the analytic record is the grid's
    (:func:`grid_cell`), and a probe runs on the ``n_ranks`` world beside
    it.  Returns the analytic records with their probes under
    ``"probe_record"``."""
    results = []
    for arch in archs:
        for shape in shapes:
            t0 = time.time()
            prec = (probe_cell(arch, shape, n_ranks, out_dir, seq_shard,
                               overrides, tag, device=device, world=world,
                               seed=seed) if probe else None)
            if grid is not None:
                rec = grid_cell(arch, shape, grid, out_dir, seq_shard,
                                verbose=False, overrides=overrides, tag=tag,
                                device=device,
                                probe_ranks=n_ranks if probe else None)
            else:
                rec = run_cell(arch, shape, n_ranks, out_dir, seq_shard,
                               verbose=False, overrides=overrides, tag=tag,
                               device=device, probe=prec)
            if prec is not None and prec["status"] == "failed":
                rec = {**rec, "status": "failed", "error": prec["error"]}
            rec["probe_record"] = prec
            status = rec["status"]
            if status == "ok" and prec is not None and \
                    prec["status"] != "ok":
                extra = f" probe {prec['status']}: {prec['reason'][:160]}"
            elif status == "ok":
                extra = ""
            else:
                extra = f" reason={rec.get('reason', rec.get('error', ''))[:160]}"
            print(f"[dryrun] {arch:24s} {shape:12s} {rec['mesh']:7s} "
                  f"{status:8s} ({time.time() - t0:.1f}s){extra}", flush=True)
            results.append(rec)
    return results


def summarize(results: list) -> dict:
    """Counts of ok / skipped / failed cells and of skipped probes."""
    count = {s: sum(r["status"] == s for r in results)
             for s in ("ok", "skipped", "failed")}
    count["probes_skipped"] = sum(
        (r.get("probe_record") or {}).get("status") == "skipped"
        and r["status"] == "ok" for r in results)
    return count


def parse_mesh(name: str) -> dict | None:
    """``--mesh``: ``none``, ``single``, ``multi`` or ``DxM`` / ``PxDxM``."""
    if name == "none":
        return None
    if name in ("single", "multi"):
        return make_production_mesh(multi_pod=name == "multi")
    return as_grid(tuple(int(n) for n in name.split("x")))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks of the world (default 1)")
    ap.add_argument("--mesh", default="none",
                    help="none (the p{ranks} world), single (16x16), multi "
                         "(2x16x16) or DxM / PxDxM: the analytic records "
                         "on that grid of ranks")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--seq-shard-decode", default="true")
    ap.add_argument("--probe", action="store_true",
                    help="cost-probe mode (a real run at a cut size)")
    ap.add_argument("--set", default=None,
                    help="config override, e.g. n_layers=2 (int values)")
    ap.add_argument("--tag", default="", help="artifact name suffix")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda raises without a card")
    args = ap.parse_args()
    device = check_device(args.device)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    world = open_world(args.ranks, device) if args.probe else None
    try:
        results = run(archs, shapes, args.ranks, args.out,
                      probe=args.probe,
                      seq_shard=args.seq_shard_decode.lower() == "true",
                      overrides=_parse_set(args.set), tag=args.tag,
                      device=device, world=world, grid=parse_mesh(args.mesh))
    finally:
        if world is not None:
            world.close()
    count = summarize(results)
    print(f"\n[dryrun] {len(results)} cells: {count['ok']} ok "
          f"({count['probes_skipped']} without a probe), "
          f"{count['skipped']} skipped, {count['failed']} failed")
    failed = [r for r in results if r["status"] == "failed"]
    if failed:
        for r in failed:
            print(f"  FAILED {r['arch']} {r['shape']} {r['mesh']}: "
                  f"{r['error']}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
