"""Serving on a grid of ranks (``models.api``'s grid prefill and decode
step, ``serve.engine.Engine(..., grid=)``, ``launch/grid_serve.py``,
``launch.serve --mesh``) against the port's one-process path and the
reference's, on the CPU.

One module world of four gloo CPU ranks serves every grid.  The model is
llama3.2-3b reduced (4 q heads, 2 kv heads, d_ff 128, vocab 256) in f64
(``tests/_x64.py``), its weights the reference's through ``interop``.
Four prompts right-padded to 32 tokens (31, 32, 29 and 17 real) are
prefilled into a cache of 64 positions and decoded 4 steps (the last
prompt token replayed at ``len - 1`` first, as the engine does), so that
rows cross the shard boundaries of 32 (model = 2) and 16 (model = 4).

Tolerances:
* against the port's one-process ``prefill`` / ``decode_step`` on the same
  weights (the grid fed the one-process run's tokens): logits of every
  step and every leaf of the cache within 1e-10 of their norm
  (``GRID_TOL``), greedy tokens equal.  The sums are regrouped (heads and
  vocab columns over 'model', flash-decoding's partial softmax over the
  position shards); f64's unit is 1.1e-16;
* against the reference's ``api.prefill`` / ``api.decode_step`` (no mesh)
  on its own weights: logits within ``test_torch_decode.py``'s 3e-3
  (``LOGIT_TOL``): the reference's decode scores are f32 even in its x64
  run (``preferred_element_type=jnp.float32``,
  ``src/repro/models/layers.py:179-180``);
* the engine's greedy tokens exactly equal to the one-process engine's,
  the reference engine's and the grid's stepwise oracle's; temperature
  draws equal on every model rank of a row (the same bits), and on (1, 2)
  equal to the one-process engine's draws for the same seed.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import api as japi
from repro.models import init_params as jinit
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
import jax.numpy as jnp
import repro_torch.configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import SolverWorld
from repro_torch.core.grid import as_grid, coords_of, grid_size
from repro_torch.interop import lm_params_from_reference
from repro_torch.launch import inputs as I
from repro_torch.launch.grid_serve import (grid_engine, grid_oracle,
                                           grid_serve, one_process_serve,
                                           refusals_on_grid, sample_on_grid)
from repro_torch.models import api
from repro_torch.models.sharding import assemble
from repro_torch.serve import Engine, ServeConfig

from _x64 import x64_mode  # noqa: F401  (autouse fixture)

GRID_TOL = 1e-10
LOGIT_TOL = 3e-3
MAX_SEQ, STEPS = 64, 4
LENS = (31, 32, 29, 17)
GRIDS = [(1, 2), (2, 1), (2, 2), (1, 4)]


@pytest.fixture(scope="module")
def world():
    with SolverWorld(4, device="cpu", kernels=False) as w:
        yield w


def _f64(get, arch, **kw):
    f64 = torch.float64 if get is tconfigs.get_reduced else jnp.float64
    return dataclasses.replace(get(arch), dtype=f64, param_dtype=f64, **kw)


_CASES = {}


def _case(**kw):
    """(port cfg, reference cfg, reference params, the port's whole
    parameter tree, tokens, lens, the one-process run, the reference's
    logits (steps + 1, B, Vpad)) of llama3.2-3b reduced in f64."""
    key = tuple(sorted(kw.items()))
    if key not in _CASES:
        jc = _f64(jconfigs.get_reduced, "llama3_2_3b", **kw)
        tc = _f64(tconfigs.get_reduced, "llama3_2_3b", **kw)
        jparams = jinit(japi.param_specs(jc), jax.random.key(0))
        params = lm_params_from_reference(jax.tree.map(np.asarray, jparams),
                                          tc, device="cpu").param_tree()
        rng = np.random.default_rng(3)
        tokens = rng.integers(0, tc.vocab, size=(len(LENS), 32))
        lens = np.asarray(LENS)
        tokens[np.arange(32)[None, :] >= lens[:, None]] = 0   # the padding
        tokens, lens = torch.from_numpy(tokens), torch.from_numpy(lens)
        one = one_process_serve(tc, params, tokens, lens, MAX_SEQ, STEPS)
        lj, cj = japi.prefill(jparams, jc, {"tokens": jnp.asarray(tokens)},
                              max_seq=MAX_SEQ)
        ref = [np.asarray(lj)]
        for t in range(STEPS):
            lj, cj = japi.decode_step(
                jparams, jc, cj, jnp.asarray(one["fed"][t].numpy()),
                jnp.asarray((lens - 1 + t).numpy()))
            ref.append(np.asarray(lj))
        _CASES[key] = (tc, jc, jparams, params, tokens, lens, one,
                       np.stack(ref))
    return _CASES[key]


def _rel(a, b) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _hold(got, one, ref, tc, grid, seq_shard):
    """The grid's run against the one-process run and the reference's."""
    for t in range(STEPS + 1):
        assert _rel(got["logits"][t], one["logits"][t]) <= GRID_TOL, t
    assert torch.equal(got["picks"], one["picks"])
    for sub, leaves in one["cache"]["blocks"].items():
        for k, want in leaves.items():
            assert _rel(got["cache"]["blocks"][sub][k], want) <= GRID_TOL, k
    np.testing.assert_allclose(got["logits"].numpy(), ref, rtol=0,
                               atol=LOGIT_TOL)
    # the cache blocks have decode_specs' shapes (one source of truth)
    shape = ShapeConfig("serve", MAX_SEQ, len(LENS), "decode")
    _, cache, _, _ = I.decode_specs(tc, shape, grid=as_grid(grid),
                                    seq_shard=seq_shard)
    want = {k: tuple(v.shape[1:]) for k, v in
            cache["blocks"]["sub0"].items()}
    for shapes in got["cache_shapes"]:
        assert {k: v[1:] for k, v in shapes.items()} == want


@pytest.mark.parametrize("seq_shard", [True, False], ids=["seq", "heads"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_grid_prefill_and_decode(world, grid, seq_shard):
    """Prefill + 4 decode steps on the grid against the port's one
    process (1e-10) and the reference (3e-3); the cache blocks'
    shapes; the collectives a step by group."""
    tc, _, _, params, tokens, lens, one, ref = _case()
    got = grid_serve(world, grid, tc, params, tokens, lens, MAX_SEQ, STEPS,
                     feed=one["fed"], seq_shard=seq_shard, keep_cache=True)
    _hold(got, one, ref, tc, grid, seq_shard)
    L, M = tc.n_layers, as_grid(grid)["model"]
    for calls in got["calls"]:
        if M == 1:
            assert all(c["all_reduces"] == 0 and c["all_gathers"] == 0
                       for c in calls.values())
            continue
        m = calls["model"]
        # embed + (wo, MLP) a layer; under cache_seq also flash-decoding's
        # max and sum and one all-gather of the q heads a layer
        assert m["all_reduces"] == 1 + (4 if seq_shard else 2) * L
        assert m["max_reduces"] == (L if seq_shard else 0)
        assert m["all_gathers"] == (L if seq_shard else 0)
        assert all(c["all_reduces"] == 0 for k, c in calls.items()
                   if k != "model")


@pytest.mark.parametrize("seq_shard", [True, False], ids=["seq", "heads"])
@pytest.mark.parametrize("case", ["kv_replicated", "heads_dropped"])
def test_guarded_heads(world, case, seq_shard):
    """q heads cut with the kv heads whole (2 kv heads on model = 4: q
    head h meets kv head h // G) and q heads the guard drops (3 q heads,
    1 kv head on model = 2: attention whole on every rank, flash-decoding
    still over the position shards), against one process and the
    reference."""
    if case == "kv_replicated":
        grid, kw = (1, 4), {}
    else:
        grid, kw = (1, 2), {"n_heads": 3, "n_kv_heads": 1}
    tc, _, _, params, tokens, lens, one, ref = _case(**kw)
    got = grid_serve(world, grid, tc, params, tokens, lens, MAX_SEQ, STEPS,
                     feed=one["fed"], seq_shard=seq_shard, keep_cache=True)
    _hold(got, one, ref, tc, grid, seq_shard)
    m = got["calls"][0]["model"]
    if case == "heads_dropped":     # no all-reduce after wo, no gather
        assert m["all_gathers"] == 0
        assert m["all_reduces"] == 1 + (3 if seq_shard else 1) * tc.n_layers


@pytest.mark.parametrize("seq_shard", [True, False], ids=["seq", "heads"])
def test_fsdp_forced_on(world, seq_shard):
    """``cfg.fsdp`` on (2, 2): each layer's weights gathered over 'data'
    before use, in prefill and every decode step."""
    tc, _, _, params, tokens, lens, one, ref = _case()
    tc = dataclasses.replace(tc, fsdp=True)
    got = grid_serve(world, (2, 2), tc, params, tokens, lens, MAX_SEQ,
                     STEPS, feed=one["fed"], seq_shard=seq_shard,
                     keep_cache=True)
    _hold(got, one, ref, tc, (2, 2), seq_shard)
    assert all(c["data"]["all_gathers"] > 0 for c in got["calls"])


@pytest.mark.parametrize("seq_shard", [True, False], ids=["seq", "heads"])
@pytest.mark.parametrize("grid", [(2, 2), (16, 16)],
                         ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("arch", ["llama3_2_3b", "mistral_nemo_12b",
                                  "qwen2_0_5b", "granite_3_2b"])
def test_cache_blocks_have_decode_specs_shapes(arch, grid, seq_shard):
    """``init_cache(..., grid=)`` at the published width, decode_32k's
    shape: every leaf's block has ``launch.inputs.decode_specs``' shape
    (meta tensors, no memory)."""
    cfg = tconfigs.get_config(arch)
    shape = tconfigs.SHAPES["decode_32k"]
    _, want, _, _ = I.decode_specs(cfg, shape, grid=grid,
                                   seq_shard=seq_shard)
    got = api.init_cache(cfg, shape.global_batch, shape.seq_len, "meta",
                         grid=grid, seq_shard=seq_shard)
    for sub, leaves in want["blocks"].items():
        for k, t in leaves.items():
            assert got["blocks"][sub][k].shape == t.shape, (sub, k)
    k = got["blocks"]["sub0"]["k"]
    if seq_shard:       # every kv head, S / M positions
        assert k.shape[2:4] == (shape.seq_len // grid[1], cfg.n_kv_heads)


def test_cut_cache_assembles_back():
    """``cut_cache`` on every rank of (2, 2) under both layouts: blocks of
    ``init_cache(..., grid=)``'s shapes that assemble into the whole."""
    tc = tconfigs.get_reduced("llama3_2_3b")
    g = torch.Generator().manual_seed(0)
    whole = {"blocks": {"sub0": {
        k: torch.randn((tc.n_layers, 4, MAX_SEQ, tc.n_kv_heads,
                        tc.resolved_head_dim), generator=g)
        for k in ("k", "v")}}}
    grid = as_grid((2, 2))
    for seq_shard in (True, False):
        blocks = [api.cut_cache(whole, tc, grid, coords_of(r, grid),
                                seq_shard) for r in range(grid_size(grid))]
        zeros = api.init_cache(tc, 4, MAX_SEQ, "cpu", grid=grid,
                               seq_shard=seq_shard)
        specs = api.cache_shardings(tc, 4, MAX_SEQ, grid, seq_shard)
        for k in ("k", "v"):
            assert blocks[0]["blocks"]["sub0"][k].shape == \
                zeros["blocks"]["sub0"][k].shape
            got = assemble([b["blocks"]["sub0"][k] for b in blocks],
                           specs["blocks"]["sub0"][k], grid)
            assert torch.equal(got, whole["blocks"]["sub0"][k])


ENGINE_PROMPTS = ([5, 6, 7, 8], list(range(1, 33)), [9] * 17,
                  list(range(40, 80)))


@pytest.mark.parametrize("seq_shard", [True, False], ids=["seq", "heads"])
def test_engine_greedy_on_2x2(world, seq_shard):
    """Four requests through the engine on (2, 2) (two a row; the
    32-token prompt replays at 31 on shard 0 and decodes at 32 on shard
    1): the one-process engine's, the reference engine's and the grid's
    stepwise oracle's tokens, on every rank."""
    tc, jc, jparams, params, *_ = _case()
    sc = {"max_seq": MAX_SEQ, "slots": 4, "min_bucket": 16}
    prompts = [list(p) for p in ENGINE_PROMPTS]
    recs = grid_engine(world, (2, 2), tc, params, prompts, 6,
                       ServeConfig(**sc), seq_shard=seq_shard)
    one = Engine(tc, api.build_model(tc, params),
                 ServeConfig(**sc)).generate(prompts, 6)
    assert all(r["outs"] == one for r in recs)
    assert [len(o) for o in one] == [6] * 4
    assert one == JEngine(jc, jparams, JServeConfig(**sc)).generate(
        prompts, 6)
    assert grid_oracle(world, (2, 2), tc, params, prompts, 6,
                       ServeConfig(**sc), seq_shard=seq_shard)["outs"] == one
    # a rank holds its row's 2 slots of the cache
    want = I.tree_bytes(api.init_cache(tc, 4, MAX_SEQ, "meta",
                                       grid=(2, 2), seq_shard=seq_shard))
    assert all(r["cache_bytes"] == want for r in recs)


def test_engine_temperature(world):
    """Temperature 1: every model rank of a row draws the same tokens
    (2, 2), and on (1, 2) the one-process engine's draws for the same
    seed."""
    tc, _, _, params, *_ = _case()
    sc = ServeConfig(max_seq=MAX_SEQ, slots=4, min_bucket=16,
                     temperature=1.0, seed=5)
    prompts = [list(p) for p in ENGINE_PROMPTS]
    recs = grid_engine(world, (2, 2), tc, params, prompts, 6, sc)
    assert recs[0]["row_outs"] == recs[1]["row_outs"]
    assert recs[2]["row_outs"] == recs[3]["row_outs"]
    assert all(r["outs"] == recs[0]["outs"] for r in recs)
    one = Engine(tc, api.build_model(tc, params), sc).generate(prompts, 6)
    recs = grid_engine(world, (1, 2), tc, params, prompts, 6, sc)
    assert all(r["outs"] == one for r in recs)
    assert all(0 <= t < tc.vocab for o in one for t in o)


def test_sampling_from_vocab_blocks(world):
    """On (1, 2) with a padded vocabulary (250 of 256 columns): a tie
    across the two ranks' blocks takes the lower index, a tie inside a
    block its first index, the padded columns (in the last rank's block)
    are never taken even when largest, random rows give torch.argmax's
    tokens; one all-gather a call; temperature draws come from the
    gathered rows (every rank the same)."""
    tc = dataclasses.replace(tconfigs.get_reduced("llama3_2_3b"), vocab=250)
    assert tc.padded_vocab == 256
    logits = torch.randn((6, 256), generator=torch.Generator().manual_seed(2),
                         dtype=torch.float64)
    logits[0, 100] = logits[0, 200] = 9.0          # across the blocks
    logits[1, 130] = logits[1, 140] = 9.0          # inside rank 1's
    logits[2, 252] = 1e9                           # a padded column
    logits[3, 250:] = 1e9
    logits[3, 3] = logits[3, 249] = 8.0
    recs = sample_on_grid(world, (1, 2), tc, logits, 0.0)
    want = torch.argmax(logits[:, :250], dim=-1)
    assert want[:2].tolist() == [100, 130] and want[3] == 3
    for r in recs:
        assert torch.equal(r["greedy"], want)
        assert torch.equal(r["sampled"], want)
        assert torch.equal(r["whole"], logits)
        assert r["calls"]["all_gathers"] == 3   # greedy, sample, whole
    recs = sample_on_grid(world, (1, 2), tc, logits, 1.0)
    assert torch.equal(recs[0]["sampled"], recs[1]["sampled"])
    assert (recs[0]["sampled"] < 250).all()


def test_families_not_ported_refused_on_a_grid(world):
    """On a (2, 2) grid the hybrid and moe configs raise, naming the ROADMAP
    queue, in grid_model, prefill, decode_step and the engine (before
    any collective: nothing is served replicated in their place); the
    engine also refuses a whole model on model > 1 and FSDP over 'data'."""
    params = api.init_model(tconfigs.get_reduced("llama3_2_3b"),
                            torch.Generator().manual_seed(0)).param_tree()
    for msgs in refusals_on_grid(world, (2, 2), params,
                                 ("jamba_1_5_large_398b",
                                  "phi3_5_moe_42b")):
        assert all("ROADMAP" in m for m in msgs[:8]), msgs
        assert "grid_model" in msgs[8] and "FSDP" in msgs[9]


def test_serve_launcher_on_a_grid():
    """``launch.serve --mesh 2x2`` on gloo CPU ranks: every request's
    tokens; ``--mesh 1x2`` serves the ssm family; ``--mesh`` refuses a
    family the grid does not run."""
    from repro_torch.launch.serve import main
    outs = main(["--mesh", "2x2", "--device", "cpu", "--requests", "4",
                 "--max-new", "3", "--seq-shard-decode", "false"])
    assert [len(o) for o in outs] == [3] * 4
    outs = main(["--arch", "mamba2_370m", "--mesh", "1x2", "--device",
                 "cpu", "--requests", "4", "--max-new", "3"])
    assert [len(o) for o in outs] == [3] * 4
    with pytest.raises(ValueError, match="ROADMAP"):
        main(["--arch", "jamba_1_5_large_398b", "--mesh", "1x2",
              "--device", "cpu"])
