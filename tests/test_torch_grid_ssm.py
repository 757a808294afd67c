"""The ssm family (mamba2-370m) trained and served on a grid of ranks
(``models.mamba2``'s grid block and decode step, ``models.api``'s
``GridLayout`` with ``tp_inner`` / ``tp_ssm_heads``, the ssm cache on a
grid; ``launch/grid_train.py``, ``launch/grid_serve.py``, ``launch.train``
/ ``launch.serve --mesh``) against the port's one-process path and the
reference's, on the CPU.

One module world of four gloo CPU ranks serves every grid.  The model is
mamba2-370m reduced (d_model 64, d_inner 128, 8 heads of 16 channels,
d_state 16, SSD chunk 32, 2 layers, vocab 256) in f64 (``tests/_x64.py``),
its weights the reference's through ``interop``; tokens and labels are
drawn with numpy from a seed, 4 rows of 64 tokens (two SSD chunks).  The
mixed cut is the same model with ``head_dim = 64``: 2 heads, which the
guard keeps whole on 'model' = 4 while d_inner is cut (each rank holds 32
channels of a 64-channel head).  Serving prefills four prompts of 64 real
tokens and decodes 4 steps (the last prompt token fed first, then the one
process's tokens).

Tolerances:
* serving on a grid against the port's one process on the same weights
  and inputs: the prefill's logits within 1e-10 of their norm
  (``GRID_TOL``), greedy tokens equal, every decode step's logits and
  every leaf of the cache within ``ISLAND_SERVE_TOL`` = 2e-6.  The
  forward's regrouped sums are f64 (rows over 'data', the gated norm's sum
  of squares and ``out``'s rows over 'model'); the ssm's f32 islands (dt,
  B, C, the SSD scan and its state, as in the reference) are not
  regrouped, a rank scanning its heads with the one process's f32
  operations.  But the CPU's f32 softplus of dt rounds a tensor of 32
  elements (a decode step's 4 rows x 8 heads in one process) otherwise
  than one of 16 or 8 (a rank's rows or heads) by an ulp here and there,
  which the decode's state carries on: read 1.7e-7 on the logits and at
  most 4.9e-8 on the cache on every grid.  The mixed cut, whose ranks run
  every f32 operation at the one process's shapes, is held at 1e-10
  throughout (read: 7.5e-16);
* a train step on a grid against the one process's: the loss within
  1e-10 (the forward's; read: at most 1.5e-16), the grad norm within
  ``ISLAND_NORM_TOL`` = 1e-7 and every leaf of the train state within
  ``ISLAND_TOL`` = 3e-5 of its norm.  The backward regroups f32 sums of
  the islands: B's and C's gradients are f32 sums over the rank's heads
  then over 'model', those of the f32 leaves (A_log, D, dt_bias) and of
  dt f32 sums over the rank's rows and channels, where one process sums
  in another f32 order.  Read on the CPU over the grids below: the grad
  norm 7.6e-9 (5.0e-11 on (2, 1)), m and v at most 3.4e-6 of a leaf's
  norm (A_log's, dt_bias's; f32's unit is 6e-8), the master and the
  parameters at most 2.4e-6 (the mixed cut's embedding, where a tiny
  gradient's sign flips its first Adam move).  A gradient a rank misses
  or counts twice moves a leaf by O(1) of its norm;
* against the reference (no mesh): the loss against its ``loss_fn`` within
  1e-5 (its x64 loss is f32); serving logits against its ``prefill`` +
  ``decode_step`` within 3e-3 (its decode's products are f32).  Not its
  ``Engine``, whose replay of the last prompt token departs (ROADMAP.md
  queue 3);
* the engine's greedy tokens exactly equal to the one-process engine's and
  the grid's stepwise oracle's; ZeRO-1 on (2, 1) against the replicated
  world (f32): the same bytes in every block.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import api as japi
from repro.models import init_params as jinit
import repro_torch.configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import SolverWorld
from repro_torch.core.grid import as_grid, coords_of, grid_size
from repro_torch.data import TokenStream
from repro_torch.interop import lm_params_from_reference, train_state_to_numpy
from repro_torch.launch import inputs as I
from repro_torch.launch.grid_serve import (grid_engine, grid_oracle,
                                           grid_serve, one_process_serve)
from repro_torch.launch.grid_train import (grid_train_steps,
                                           one_process_steps,
                                           zero1_against_replicated)
from repro_torch.models import api
from repro_torch.models.sharding import assemble
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train import TrainRunConfig

from _x64 import x64_mode  # noqa: F401  (autouse fixture)

ARCH = "mamba2_370m"
GRID_TOL = 1e-10
ISLAND_NORM_TOL = 1e-7
ISLAND_TOL = 3e-5
ISLAND_SERVE_TOL = 2e-6
STEP_LOSS_TOL = 1e-5
LOGIT_TOL = 3e-3
LR = 1e-3
ROWS, SEQ = 4, 64
MAX_SEQ, STEPS = 128, 4
GRIDS = [(1, 2), (2, 1), (2, 2), (1, 4)]
MIXED = {"head_dim": 64}                 # 2 heads: whole on model = 4


@pytest.fixture(scope="module")
def world():
    with SolverWorld(4, device="cpu", kernels=False) as w:
        yield w


def _gid(g):
    return "x".join(map(str, g))


def _cfgs(head_dim=None):
    """(reference cfg, port cfg) of mamba2 reduced in f64, with
    ``head_dim`` replaced on both sides when given."""
    out = []
    for get, f64 in ((jconfigs.get_reduced, jnp.float64),
                     (tconfigs.get_reduced, torch.float64)):
        cfg = dataclasses.replace(get(ARCH), dtype=f64, param_dtype=f64)
        if head_dim is not None:
            cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
                cfg.ssm, head_dim=head_dim))
        out.append(cfg)
    return tuple(out)


_MODELS = {}


def _model(head_dim=None):
    """(reference cfg, port cfg, reference params, the port's whole
    parameter tree)."""
    if head_dim not in _MODELS:
        jc, tc = _cfgs(head_dim)
        jparams = jinit(japi.param_specs(jc), jax.random.key(0))
        params = lm_params_from_reference(jax.tree.map(np.asarray, jparams),
                                          tc, device="cpu").param_tree()
        _MODELS[head_dim] = (jc, tc, jparams, params)
    return _MODELS[head_dim]


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree, dtype=np.float64)


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


class _StandIn:
    """A rank's grid handle for a layout's flags alone (no collective)."""

    def __init__(self, grid):
        self.grid = as_grid(grid)
        self.coords = {"data": 0, "model": 0}
        M = self.grid["model"]
        self.model = types.SimpleNamespace(size=M) if M > 1 else None
        self.data = None


# ----------------------------------------------------------------- training --

_TRAIN = {}


def _train_case(head_dim=None):
    """(port cfg, params, the batch, the one-process step's metrics and
    state, the reference's loss) of one train step."""
    if head_dim not in _TRAIN:
        jc, tc, jparams, params = _model(head_dim)
        batch = TokenStream(tc.vocab, SEQ, ROWS, seed=3).batch_at(0)
        batch["mask"][1, 40:] = 0.0              # a masked tail
        one_m, one, _ = one_process_steps(tc, params, batch, lr=LR)
        jloss, _ = japi.loss_fn(jparams, jc, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
        _TRAIN[head_dim] = (tc, params, batch, one_m,
                            dict(_flat(train_state_to_numpy(one))),
                            float(jloss))
    return _TRAIN[head_dim]


def _hold_step(got, one_m, one):
    for k, tol in (("loss", GRID_TOL), ("grad_norm", ISLAND_NORM_TOL)):
        assert abs(got["metrics"][k] - one_m[k]) <= tol * abs(one_m[k]), k
    new = dict(_flat(train_state_to_numpy(got["state"])))
    assert new.keys() == one.keys()
    for k in one:
        assert _rel(new[k], one[k]) <= ISLAND_TOL, k


@pytest.mark.parametrize("fsdp", [False, True], ids=["zero1", "fsdp"])
@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
def test_grid_train_step(world, grid, fsdp):
    """One train step on the grid (mamba's d_inner and heads over
    'model', ZeRO-1 over 'data', FSDP forced on) against the one-process
    step at 1e-10, and its loss against the reference's ``loss_fn``."""
    tc, params, batch, one_m, one, jloss = _train_case()
    tc = dataclasses.replace(tc, fsdp=fsdp)
    got = grid_train_steps(world, grid, tc, params, batch, lr=LR)
    _hold_step(got, one_m, one)
    np.testing.assert_allclose(got["metrics"]["loss"], jloss, rtol=0,
                               atol=STEP_LOSS_TOL)
    g = as_grid(grid)
    for c in got["counters"]:
        if g["model"] > 1:
            assert c["model"]["all_reduces"] > 0
            assert c["model"]["all_gathers"] == 0    # the heads are cut
        if fsdp and g["data"] > 1:
            assert c["data"]["all_gathers"] > 0
            assert c["data"]["reduce_scatters"] > 0


# ------------------------------------------------------------------ serving --

_SERVE = {}


def _serve_case(head_dim=None):
    """(port cfg, params, tokens, lens, the one-process run, a function
    giving the reference's logits (steps + 1, B, Vpad), run on its first
    call)."""
    if head_dim not in _SERVE:
        jc, tc, jparams, params = _model(head_dim)
        rng = np.random.default_rng(3)
        tokens = torch.from_numpy(rng.integers(0, tc.vocab, size=(ROWS, SEQ)))
        lens = torch.full((ROWS,), SEQ)
        one = one_process_serve(tc, params, tokens, lens, MAX_SEQ, STEPS)
        ref = []

        def reference():
            if ref:
                return ref[0]
            lj, cj = japi.prefill(jparams, jc,
                                  {"tokens": jnp.asarray(tokens.numpy())},
                                  max_seq=MAX_SEQ)
            out = [np.asarray(lj)]
            for t in range(STEPS):
                lj, cj = japi.decode_step(
                    jparams, jc, cj, jnp.asarray(one["fed"][t].numpy()),
                    jnp.asarray((lens - 1 + t).numpy()))
                out.append(np.asarray(lj))
            ref.append(np.stack(out))
            return ref[0]
        _SERVE[head_dim] = (tc, params, tokens, lens, one, reference)
    return _SERVE[head_dim]


def _hold_serve(got, one, ref=None, tol=ISLAND_SERVE_TOL):
    """The logits (the prefill's at ``GRID_TOL``, the decode steps' at
    ``tol``), the picks and every cache leaf (``tol``) against one
    process's, and the logits against the reference's."""
    for t in range(STEPS + 1):
        assert _rel(got["logits"][t], one["logits"][t]) <= (
            tol if t else GRID_TOL), t
    assert torch.equal(got["picks"], one["picks"])
    for k, want in _flat(one["cache"]):
        have = got["cache"]
        for part in k:
            have = have[part]
        assert have.shape == want.shape, k
        assert _rel(have, want) <= tol, k
    if ref is not None:
        np.testing.assert_allclose(got["logits"].numpy(), ref, rtol=0,
                                   atol=LOGIT_TOL)


def _run(world, grid, case, seq_shard):
    tc, params, tokens, lens, one, _ = case
    return grid_serve(world, grid, tc, params, tokens, lens, MAX_SEQ, STEPS,
                      feed=one["fed"], seq_shard=seq_shard, keep_cache=True)


@pytest.mark.parametrize("seq_shard", [True, False], ids=["seq", "heads"])
@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
def test_grid_prefill_and_decode(world, grid, seq_shard):
    """Prefill + 4 decode steps on the grid against the port's one
    process (1e-10) and the reference (3e-3); the cache blocks have
    ``decode_specs``' shapes; a decode step's and the prefill's
    collectives over 'model': 1 + 2 L all-reduces (the embedding; a
    layer's norm and ``out``), nothing else, none over (pod, data)."""
    case = _serve_case()
    tc = case[0]
    got = _run(world, grid, case, seq_shard)
    _hold_serve(got, one=case[4], ref=case[5]())
    shape = ShapeConfig("serve", MAX_SEQ, ROWS, "decode")
    _, cache, _, _ = I.decode_specs(tc, shape, grid=as_grid(grid),
                                    seq_shard=seq_shard)
    want = {k: tuple(v.shape[1:]) for k, v in cache["blocks"]["sub0"].items()}
    for shapes in got["cache_shapes"]:
        assert {k: v[1:] for k, v in shapes.items()} == want
    L, M = tc.n_layers, as_grid(grid)["model"]
    for calls in (got["calls"], got["prefill_calls"]):
        for c in calls:
            assert all(g["all_reduces"] == 0 for k, g in c.items()
                       if k != "model")
            if M == 1:
                continue
            m = c["model"]
            assert m["all_reduces"] == 1 + 2 * L
            assert m["max_reduces"] == m["all_gathers"] == 0
            assert m["all_to_alls"] == 0


def test_seq_shard_settings_give_the_same_bits(world):
    """The ssm cache has no positions: ``seq_shard`` True and False give
    the same logits and cache blocks, bit for bit, on (2, 2)."""
    case = _serve_case()
    a, b = (_run(world, (2, 2), case, s) for s in (True, False))
    assert torch.equal(a["logits"], b["logits"])
    assert torch.equal(a["picks"], b["picks"])
    for (k, x), (_, y) in zip(_flat(a["cache"]), _flat(b["cache"])):
        assert np.array_equal(x, y), k


# ------------------------------------------------------------ the mixed cut --

def test_mixed_cut_layout():
    """head_dim 64 on (1, 4): d_inner (128) is cut, the 2 heads are whole
    (the guard drops them), and so are the ``ssm`` cache's heads."""
    tc = _cfgs(**MIXED)[1]
    lay = api.GridLayout(tc, _StandIn((1, 4)))
    assert (lay.tp_inner, lay.tp_ssm_heads, lay.tp_vocab) == \
        (True, False, True)
    assert (lay.tp_heads, lay.tp_kv, lay.tp_mlp, lay.group) == \
        (False, False, False, None)
    specs = api.cache_shardings(tc, ROWS, MAX_SEQ, (1, 4))["blocks"]["sub0"]
    assert specs["ssm"][2] is None and specs["conv_x"][3] == "model"
    lay = api.GridLayout(_cfgs()[1], _StandIn((1, 4)))
    assert (lay.tp_inner, lay.tp_ssm_heads) == (True, True)


@pytest.mark.parametrize("mode", ["train", "serve"])
def test_mixed_cut(world, mode):
    """head_dim 64 on (1, 4): each rank holds 32 channels of a 64-channel
    head; the ranks' conv'd channels are all-gathered over 'model' and
    every rank scans every head (the whole ``ssm`` state, whole in the
    cache on every rank); against one process at 1e-10 and the
    reference."""
    if mode == "train":
        tc, params, batch, one_m, one, jloss = _train_case(**MIXED)
        got = grid_train_steps(world, (1, 4), tc, params, batch, lr=LR)
        _hold_step(got, one_m, one)
        np.testing.assert_allclose(got["metrics"]["loss"], jloss, rtol=0,
                                   atol=STEP_LOSS_TOL)
        return
    case = _serve_case(**MIXED)
    tc = case[0]
    got = _run(world, (1, 4), case, True)
    _hold_serve(got, one=case[4], ref=case[5](), tol=GRID_TOL)
    H, P = tc.ssm.n_heads(tc.d_model), tc.ssm.head_dim
    for shapes, calls in zip(got["cache_shapes"], got["calls"]):
        assert shapes["ssm"][2:4] == (H, P)          # every head, whole
        assert shapes["conv_x"][3] == tc.ssm.d_inner(tc.d_model) // 4
        m = calls["model"]
        assert (m["all_reduces"], m["all_gathers"]) == \
            (1 + 2 * tc.n_layers, tc.n_layers)


# ---------------------------------------------------------------- the engine --

ENGINE_PROMPTS = (list(range(1, 33)), [9] * 64, list(range(40, 72)),
                  list(range(100, 164)))


@pytest.mark.parametrize("grid", [(2, 2), (1, 2)], ids=_gid)
def test_engine_greedy_on_a_grid(world, grid):
    """Four requests of one and two SSD chunks through the engine on the
    grid (each prompt prefilled unpadded, its first token the prefill's):
    the one-process engine's and the grid's stepwise oracle's tokens, on
    every rank."""
    tc, params = _model()[1], _model()[3]
    sc = ServeConfig(max_seq=MAX_SEQ, slots=4)
    prompts = [list(p) for p in ENGINE_PROMPTS]
    recs = grid_engine(world, grid, tc, params, prompts, 6, sc)
    one = Engine(tc, api.build_model(tc, params), sc).generate(prompts, 6)
    assert [len(o) for o in one] == [6] * 4
    assert all(r["outs"] == one for r in recs)
    assert grid_oracle(world, grid, tc, params, prompts, 6, sc)["outs"] == one
    want = I.tree_bytes(api.init_cache(tc, 4, MAX_SEQ, "meta", grid=grid))
    assert all(r["cache_bytes"] == want for r in recs)


# ---------------------------------------------------- the (D, 1) grid's repair --

def test_d1_grid_trains_and_serves(world):
    """A (2, 1) grid: ``GridLayout`` of the ssm family (before the repair
    its constructor raised ZeroDivisionError: mamba2 has no kv heads) has
    no 'model' cut, so the grid is data-parallel -- ZeRO-1's train state
    the same bytes as the replicated world's after a step of f32, and the
    engine's tokens the one process's."""
    lay = api.GridLayout(tconfigs.get_reduced(ARCH), _StandIn((2, 1)))
    assert not (lay.tp_inner or lay.tp_ssm_heads or lay.tp_vocab
                or lay.fsdp) and lay.group is None
    cfg = dataclasses.replace(tconfigs.get_reduced(ARCH),
                              dtype=torch.float32, param_dtype=torch.float32)
    run = TrainRunConfig(steps=1, global_batch=4, seq_len=32, lr=1e-2,
                         warmup=0, log_every=1, seed=4)
    for o in zero1_against_replicated(world, (2, 1), cfg, run):
        assert o["replicated"]["digests"] == o["grid"]["digests"]
        assert [h["loss"] for h in o["replicated"]["history"]] == \
            [h["loss"] for h in o["grid"]["history"]]
        end = dict(o["grid"]["digests"])
        assert all(d != end[k] for k, d in o["grid"]["start"])
    tc, params = _model()[1], _model()[3]
    sc = ServeConfig(max_seq=MAX_SEQ, slots=4)
    prompts = [list(p) for p in ENGINE_PROMPTS]
    one = Engine(tc, api.build_model(tc, params), sc).generate(prompts, 4)
    assert all(r["outs"] == one for r in grid_engine(
        world, (2, 1), tc, params, prompts, 4, sc))


# -------------------------------------------------------------- cache blocks --

@pytest.mark.parametrize("grid", [(2, 2), (16, 16)], ids=_gid)
def test_cache_blocks_at_published_width(grid):
    """``init_cache(..., grid=)`` and ``decode_specs`` at mamba2-370m's
    width, decode_32k's shape (meta tensors): the rank's heads of ``ssm``
    and channels of ``conv_x``, the whole ``conv_B`` / ``conv_C``; both
    cache layouts the same block."""
    cfg = tconfigs.get_config(ARCH)
    shape = tconfigs.SHAPES["decode_32k"]
    g = as_grid(grid)
    D, M = g["data"], g["model"]
    s = cfg.ssm
    B, H, di = (shape.global_batch // D, s.n_heads(cfg.d_model),
                s.d_inner(cfg.d_model))
    want = {"ssm": (cfg.n_layers, B, H // M, s.head_dim, s.d_state),
            "conv_x": (cfg.n_layers, B, s.d_conv - 1, di // M),
            "conv_B": (cfg.n_layers, B, s.d_conv - 1, s.d_state),
            "conv_C": (cfg.n_layers, B, s.d_conv - 1, s.d_state)}
    for seq_shard in (True, False):
        _, specs, _, _ = I.decode_specs(cfg, shape, grid=grid,
                                        seq_shard=seq_shard)
        got = api.init_cache(cfg, shape.global_batch, shape.seq_len, "meta",
                             grid=grid, seq_shard=seq_shard)
        for k, v in want.items():
            assert tuple(got["blocks"]["sub0"][k].shape) == v, k
            assert tuple(specs["blocks"]["sub0"][k].shape) == v, k


@pytest.mark.parametrize("grid", [(2, 2), (16, 16)], ids=_gid)
def test_cut_cache_round_trip_on_the_ssm_tree(grid):
    """``cut_cache`` of a whole ssm cache of mamba2-370m's width on every
    rank under both layouts: blocks of ``init_cache(..., grid=)``'s shapes
    that assemble into the whole (2 layers, 2 slots a 'data' rank)."""
    cfg = dataclasses.replace(tconfigs.get_config(ARCH), n_layers=2)
    grid = as_grid(grid)
    B = 2 * grid["data"]
    gen = torch.Generator().manual_seed(0)
    whole = {"blocks": {"sub0": {
        k: torch.randn(t.shape, generator=gen).to(t.dtype)
        for k, t in api.init_cache(cfg, B, MAX_SEQ, "meta")["blocks"][
            "sub0"].items()}}}
    ranks = range(grid_size(grid)) if grid_size(grid) <= 4 else (0, 17, 255)
    for seq_shard in (True, False):
        zeros = api.init_cache(cfg, B, MAX_SEQ, "meta", grid=grid,
                               seq_shard=seq_shard)["blocks"]["sub0"]
        specs = api.cache_shardings(cfg, B, MAX_SEQ, grid,
                                    seq_shard)["blocks"]["sub0"]
        blocks = {r: api.cut_cache(whole, cfg, grid, coords_of(r, grid),
                                   seq_shard)["blocks"]["sub0"]
                  for r in ranks}
        for k, t in whole["blocks"]["sub0"].items():
            assert all(b[k].shape == zeros[k].shape for b in blocks.values())
            if len(blocks) == grid_size(grid):
                got = assemble([blocks[r][k] for r in ranks], specs[k], grid)
                assert torch.equal(got, t), k


# ---------------------------------------------------------------- launchers --

def test_check_grid_family_admits_the_ssm_family():
    """mamba2 on every grid, with FSDP on or off; MoE and the hybrid
    (jamba) still refused, naming the ROADMAP queue."""
    for fsdp in (False, True):
        cfg = dataclasses.replace(tconfigs.get_reduced(ARCH), fsdp=fsdp)
        for grid in GRIDS + [(16, 16), (2, 16, 16)]:
            api.check_grid_family(cfg, as_grid(grid))
    for arch in ("jamba_1_5_large_398b", "phi3_5_moe_42b"):
        with pytest.raises(ValueError, match="ROADMAP"):
            api.check_grid_family(tconfigs.get_reduced(arch),
                                  as_grid((2, 2)))


def test_train_launcher_on_a_grid():
    """``launch.train --arch mamba2_370m``: ``--mesh auto`` on four cards
    picks plan_mesh's grid; ``--mesh 2x1`` (the (D, 1) grid that raised
    ZeroDivisionError before its repair) and ``2x2`` each take a step of
    finite loss on gloo CPU ranks."""
    from repro_torch.launch.train import choose_layout, main
    assert choose_layout(tconfigs.get_reduced(ARCH), "auto", 4)[1] == \
        {"data": 1, "model": 4}
    for mesh in ("2x1", "2x2"):
        hist = main(["--arch", ARCH, "--mesh", mesh, "--device", "cpu",
                     "--steps", "1"])
        assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
