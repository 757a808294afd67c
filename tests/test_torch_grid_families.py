"""The encoder-decoder (seamless-m4t-large-v2) and the vlm (llava-next-34b)
trained and served on a grid of ranks (``models.api``'s grid section:
the encoder, the cross-attention, the cross cache, the patch prefix;
``launch/grid_train.py``, ``launch/grid_serve.py``, ``launch.train`` /
``launch.serve --mesh``) against the port's one-process path and the
reference's, on the CPU.

One module world of four gloo CPU ranks serves every grid.  The models
are the reduced configs (seamless: 4 heads, 4 kv heads, 2 + 2 layers;
llava: 4 q heads, 2 kv heads, 2 layers, a 16-patch prefix) in f64
(``tests/_x64.py``), their weights the reference's through ``interop``;
tokens, labels, encoder frames and patch embeddings are drawn with numpy
from a seed.  Serving: four prompts right-padded to 32 tokens (31, 32, 29
and 17 real) into a cache of 64 positions (llava's counts its 16-patch
prefix), 4 decode steps, seamless on 128 encoder frames
(``api.cross_frames(64)``).

Tolerances (``test_torch_grid_train.py`` / ``test_torch_grid_serve.py``'s):
* a grid against the port's one process on the same weights and inputs:
  loss and grad norm within 1e-10 (``GRID_TOL``); every leaf of the train
  state within 1e-10 of its norm or, where an f32 rounding flipped, each
  element within ``F32_ULPS`` f32 ulps and at most ``FLIPS`` of them
  apart: the state after a step is f32 (master, m, v; the f64 parameters
  are the master cast back), and f64 gradients that agree to 1e-16 round
  to different f32 values wherever one lies at a rounding boundary (read
  on this model: 1-5 elements of a 16384-element leaf, 1-4 ulps, after
  m = 0.1 g and v = 0.001 g^2 round again); logits of every serving step
  and every leaf of the cache within 1e-10, greedy tokens equal.  The
  sums are regrouped (rows over 'data', heads and vocab columns over
  'model', flash-decoding's partial softmax over the position shards);
  f64's unit is 1.1e-16;
* against the reference (no mesh): the train step's loss against its
  ``loss_fn`` within 1e-5 (its x64 loss is f32); serving logits within
  3e-3 (its decode scores are f32 even in x64).
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
from repro_torch.launch.grid_serve import grid_serve, one_process_serve
from repro_torch.launch.grid_train import grid_train_steps, one_process_steps
from repro_torch.models import api
from repro_torch.models.sharding import assemble
from repro_torch.train.trainer import frontend_key

from _x64 import x64_mode  # noqa: F401  (autouse fixture)

GRID_TOL = 1e-10
F32_ULPS = 4
FLIPS = 0.01
STEP_LOSS_TOL = 1e-5
LOGIT_TOL = 3e-3
LR = 1e-3
MAX_SEQ, STEPS = 64, 4
LENS = (31, 32, 29, 17)
GRIDS = [(1, 2), (2, 1), (2, 2), (1, 4)]
ARCHS = ["seamless_m4t_large_v2", "llava_next_34b"]
ODD_FRAMES, ODD_MAX_SEQ = 130, 520      # cross_frames(520) = 130 on model 4
CUT_FRAMES = 24                         # divides model 4; not cross_frames(64)


@pytest.fixture(scope="module")
def world():
    with SolverWorld(4, device="cpu", kernels=False) as w:
        yield w


def _gid(g):
    return "x".join(map(str, g))


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get_reduced(arch), dtype=jnp.float64,
                                param_dtype=jnp.float64, **kw),
            dataclasses.replace(tconfigs.get_reduced(arch),
                                dtype=torch.float64,
                                param_dtype=torch.float64, **kw))


def _embeds(cfg, rows: int, frames: int, seed: int) -> np.ndarray:
    """Encoder frames (audio) or patch embeddings (vlm), N(0, 0.1^2) as
    ``test_torch_models.py`` draws them."""
    n = frames if cfg.family == "audio" else cfg.frontend_tokens
    return 0.1 * np.random.default_rng(seed).standard_normal(
        (rows, n, cfg.d_model))


_MODELS = {}


def _model(arch, **kw):
    """(reference cfg, port cfg, reference params, the port's whole
    parameter tree) of ``arch`` reduced in f64 (``kw`` replaces config
    fields on both sides)."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jc, tc = _cfgs(arch, **kw)
        jparams = jinit(japi.param_specs(jc), jax.random.key(0))
        params = lm_params_from_reference(jax.tree.map(np.asarray, jparams),
                                          tc, device="cpu").param_tree()
        _MODELS[key] = (jc, tc, jparams, params)
    return _MODELS[key]


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree, dtype=np.float64)


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# ----------------------------------------------------------------- training --

_TRAIN = {}


def _train_case(arch, **kw):
    """(port cfg, params, the batch, the one-process step's metrics and
    state, the reference's loss) of one train step."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _TRAIN:
        jc, tc, jparams, params = _model(arch, **kw)
        batch = TokenStream(tc.vocab, 32, 4, seed=3).batch_at(0)
        batch["mask"][1, 20:] = 0.0              # a masked tail
        batch[frontend_key(tc)] = _embeds(tc, 4, 40, seed=4)
        one_m, one, _ = one_process_steps(tc, params, batch, lr=LR)
        jloss, _ = japi.loss_fn(jparams, jc, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
        _TRAIN[key] = (tc, params, batch, one_m,
                       dict(_flat(train_state_to_numpy(one))), float(jloss))
    return _TRAIN[key]


def _hold_step(got, one_m, one):
    for k in ("loss", "grad_norm"):
        assert abs(got["metrics"][k] - one_m[k]) <= GRID_TOL * abs(one_m[k]), k
    new = dict(_flat(train_state_to_numpy(got["state"])))
    assert new.keys() == one.keys()
    for k in one:
        if _rel(new[k], one[k]) <= GRID_TOL:
            continue
        ulp = np.spacing(np.abs(one[k]).astype(np.float32))
        apart = np.abs(new[k] - one[k])
        assert (apart <= F32_ULPS * ulp).all(), k
        assert (apart > 0).mean() <= FLIPS, k


@pytest.mark.parametrize("fsdp", [False, True], ids=["zero1", "fsdp"])
@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
@pytest.mark.parametrize("arch", ARCHS)
def test_grid_train_step(world, arch, grid, fsdp):
    """One train step on the grid (tensor parallelism of the encoder, the
    cross-attention and the prefixed decoder over 'model', ZeRO-1 over
    'data', FSDP forced on) against the one-process step at 1e-10, and
    its loss against the reference's ``loss_fn``."""
    tc, params, batch, one_m, one, jloss = _train_case(arch)
    tc = dataclasses.replace(tc, fsdp=fsdp)
    got = grid_train_steps(world, grid, tc, params, batch, lr=LR)
    _hold_step(got, one_m, one)
    np.testing.assert_allclose(got["metrics"]["loss"], jloss, rtol=0,
                               atol=STEP_LOSS_TOL)
    g = as_grid(grid)
    for c in got["counters"]:
        if g["model"] > 1:
            assert c["model"]["all_reduces"] > 0
        if fsdp and g["data"] > 1:
            assert c["data"]["all_gathers"] > 0
            assert c["data"]["reduce_scatters"] > 0


# ------------------------------------------------------------------ serving --

_SERVE = {}


def _serve_case(arch, frames: int = 128, max_seq: int = MAX_SEQ, **kw):
    """(port cfg, params, tokens, lens, embeds, the one-process run, a
    function giving the reference's logits (steps + 1, B, Vpad), run on
    its first call)."""
    key = (arch, frames, max_seq, tuple(sorted(kw.items())))
    if key not in _SERVE:
        jc, tc, jparams, params = _model(arch, **kw)
        rng = np.random.default_rng(3)
        tokens = rng.integers(0, tc.vocab, size=(len(LENS), 32))
        lens = np.asarray(LENS)
        tokens[np.arange(32)[None, :] >= lens[:, None]] = 0   # the padding
        emb = _embeds(tc, len(LENS), frames, seed=5)
        tokens, lens = torch.from_numpy(tokens), torch.from_numpy(lens)
        embeds = torch.from_numpy(emb)
        one = one_process_serve(tc, params, tokens, lens, max_seq, STEPS,
                                embeds=embeds)
        off = emb.shape[1] if tc.family == "vlm" else 0
        ref = []

        def reference():
            if ref:
                return ref[0]
            lj, cj = japi.prefill(
                jparams, jc, {"tokens": jnp.asarray(tokens),
                              frontend_key(tc): jnp.asarray(emb)},
                max_seq=max_seq)
            out = [np.asarray(lj)]
            for t in range(STEPS):
                lj, cj = japi.decode_step(
                    jparams, jc, cj, jnp.asarray(one["fed"][t].numpy()),
                    jnp.asarray((off + lens - 1 + t).numpy()))
                out.append(np.asarray(lj))
            ref.append(np.stack(out))
            return ref[0]
        _SERVE[key] = (tc, params, tokens, lens, embeds, one, reference)
    return _SERVE[key]


def _hold_serve(got, one, ref=None):
    for t in range(STEPS + 1):
        assert _rel(got["logits"][t], one["logits"][t]) <= GRID_TOL, t
    assert torch.equal(got["picks"], one["picks"])
    for k, want in _flat(one["cache"]):
        have = got["cache"]
        for part in k:
            have = have[part]
        assert have.shape == want.shape, k      # never padded
        assert _rel(have, want) <= GRID_TOL, k
    if ref is not None:
        np.testing.assert_allclose(got["logits"].numpy(), ref, rtol=0,
                                   atol=LOGIT_TOL)


def _run(world, grid, case, seq_shard, max_seq=MAX_SEQ):
    tc, params, tokens, lens, embeds, one, _ = case
    return grid_serve(world, grid, tc, params, tokens, lens, max_seq, STEPS,
                      feed=one["fed"], seq_shard=seq_shard, keep_cache=True,
                      embeds=embeds)


@pytest.mark.parametrize("seq_shard", [True, False], ids=["seq", "heads"])
@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
@pytest.mark.parametrize("arch", ARCHS)
def test_grid_prefill_and_decode(world, arch, grid, seq_shard):
    """Prefill + 4 decode steps on the grid against the port's one
    process (1e-10) and the reference (3e-3); the cache blocks have
    ``decode_specs``' shapes; the collectives a step by group."""
    case = _serve_case(arch)
    tc = case[0]
    got = _run(world, grid, case, seq_shard)
    _hold_serve(got, one=case[5], ref=case[6]())
    shape = ShapeConfig("serve", MAX_SEQ, len(LENS), "decode")
    _, cache, _, _ = I.decode_specs(tc, shape, grid=as_grid(grid),
                                    seq_shard=seq_shard)
    body = cache["decoder"] if "decoder" in cache else cache["blocks"]["sub0"]
    want = {k: tuple(v.shape[1:]) for k, v in body.items()}
    for shapes in got["cache_shapes"]:
        assert {k: v[1:] for k, v in shapes.items()} == want
    L, M = tc.n_layers, as_grid(grid)["model"]
    for calls in got["calls"]:
        assert all(c["all_reduces"] == 0 for k, c in calls.items()
                   if k != "model")
        if M == 1 or tc.family != "audio":
            continue
        m = calls["model"]
        # embed + (self wo, cross wo, MLP) a layer; on a position-cut cache
        # also flash-decoding's max and sum twice a layer (self, cross) and
        # two all-gathers (the self q / k / v heads, the cross q heads)
        assert m["all_reduces"] == 1 + (7 if seq_shard else 3) * L
        assert m["max_reduces"] == (2 * L if seq_shard else 0)
        assert m["all_gathers"] == (2 * L if seq_shard else 0)


@pytest.mark.parametrize("seq_shard", [True, False], ids=["seq", "heads"])
def test_cross_cache_whose_frames_do_not_divide(world, seq_shard):
    """130 encoder frames on (1, 4) (a cache of 520 positions: its
    ``cross_frames``): under ``cache_seq`` the cross cache stays whole on
    every rank (every kv head, all 130 frames, not padded), with the kv
    heads over 'model' it keeps the rank's head; both equal to one
    process at 1e-10.  ``cache_shardings`` given those frames for a cache
    of 64 positions cuts them the same way."""
    case = _serve_case("seamless_m4t_large_v2", frames=ODD_FRAMES,
                       max_seq=ODD_MAX_SEQ)
    tc = case[0]
    assert api.cross_frames(ODD_MAX_SEQ) == ODD_FRAMES
    got = _run(world, (1, 4), case, seq_shard, ODD_MAX_SEQ)
    _hold_serve(got, one=case[5])
    heads = tc.n_kv_heads if seq_shard else tc.n_kv_heads // 4
    for shapes in got["cache_shapes"]:
        assert shapes["xk"][2:4] == (ODD_FRAMES, heads)
        assert shapes["k"][2] == (ODD_MAX_SEQ // 4 if seq_shard
                                  else ODD_MAX_SEQ)
    spec = api.cache_shardings(tc, len(LENS), ODD_MAX_SEQ, (1, 4),
                               seq_shard)["decoder"]["xk"]
    assert spec[2] is None and (spec[3] is None) == seq_shard
    assert api.cache_shardings(tc, len(LENS), MAX_SEQ, (1, 4), seq_shard,
                               frames=ODD_FRAMES)["decoder"]["xk"] == spec


@pytest.mark.parametrize("seq_shard", [True, False], ids=["seq", "heads"])
def test_cross_cache_of_frames_other_than_cross_frames(world, seq_shard):
    """24 encoder frames into a cache of 64 positions on (1, 4) (not its
    ``cross_frames``, 128; they divide 'model'): under ``cache_seq`` each
    rank holds 6 of them, every kv head; with the kv heads over 'model'
    all 24 of the rank's head; both equal to one process at 1e-10."""
    case = _serve_case("seamless_m4t_large_v2", frames=CUT_FRAMES)
    tc = case[0]
    assert api.cross_frames(MAX_SEQ) != CUT_FRAMES
    got = _run(world, (1, 4), case, seq_shard)
    _hold_serve(got, one=case[5])
    want = ((CUT_FRAMES // 4, tc.n_kv_heads) if seq_shard
            else (CUT_FRAMES, tc.n_kv_heads // 4))
    for shapes in got["cache_shapes"]:
        assert shapes["xk"][2:4] == want


def test_cross_cache_of_other_frames_is_refused(world):
    """A rank's cross cache block whose frames are not those the encoder's
    frame count (``enc_len``) gives it -- F / M where F divides 'model'
    under ``cache_seq``, else F -- raises, and so does a decode step under
    ``cache_seq`` that is not told ``enc_len`` (a block of F / M frames
    of a cut cache may be a whole one of F' = F / M frames); nothing is
    padded to make a cache fit."""
    from repro_torch.launch.grid_serve import _refused
    tc = _model("seamless_m4t_large_v2")[1]
    lay = api.GridLayout(tc, _StandIn((1, 4)))
    assert "enc_len" in _refused(lambda: api._cross_cut(
        lay, True, 128, held=128))              # cut: 32 a rank
    assert "enc_len" in _refused(lambda: api._cross_cut(
        lay, True, ODD_FRAMES, held=ODD_FRAMES // 4))   # whole: 130
    assert api._cross_cut(lay, True, 128, held=32) is True
    assert api._cross_cut(lay, True, ODD_FRAMES, held=ODD_FRAMES) is False
    assert api._cross_cut(lay, False, 128, held=128) is False
    c = {"xk": torch.zeros(1, 32, 4, 8), "xv": torch.zeros(1, 32, 4, 8)}
    p = {"wq": torch.zeros(8, 4, 8)}
    assert "enc_len" in _refused(lambda: api._grid_decode_cross(
        p, c, torch.zeros(1, 1, 8), tc, lay, True, None))


class _StandIn:
    """A rank's grid handle for a layout's flags alone (no collective)."""

    def __init__(self, grid):
        self.grid = as_grid(grid)
        self.coords = {"data": 0, "model": 0}
        M = self.grid["model"]
        self.model = types.SimpleNamespace(size=M) if M > 1 else None
        self.data = None


@pytest.mark.parametrize("mode", ["train", "seq", "heads"])
@pytest.mark.parametrize("arch", ARCHS)
def test_guarded_heads(world, arch, mode):
    """3 q heads and 1 kv head on model = 2: the guard drops both, the
    encoder's, the decoder's and the cross attention run whole on every
    rank (flash-decoding still over the position shards), against one
    process at 1e-10."""
    kw = {"n_heads": 3, "n_kv_heads": 1}
    lay = api.GridLayout(_model(arch, **kw)[1], _StandIn((1, 2)))
    assert (lay.tp_heads, lay.tp_kv, lay.tp_mlp, lay.tp_vocab) == \
        (False, False, True, True)
    if mode == "train":
        tc, params, batch, one_m, one, jloss = _train_case(arch, **kw)
        got = grid_train_steps(world, (1, 2), tc, params, batch, lr=LR)
        _hold_step(got, one_m, one)
        np.testing.assert_allclose(got["metrics"]["loss"], jloss, rtol=0,
                                   atol=STEP_LOSS_TOL)
        return
    case = _serve_case(arch, **kw)
    got = _run(world, (1, 2), case, mode == "seq")
    _hold_serve(got, one=case[5], ref=case[6]())
    m = got["calls"][0]["model"]
    assert m["all_gathers"] == 0        # no q heads to gather


@pytest.mark.parametrize("mode", ["train", "seq", "heads"])
def test_seamless_kv_heads_whole_under_cut_q_heads(world, mode):
    """4 q heads and 2 kv heads on model = 4: the q heads are cut, the kv
    heads whole (each rank's q head h meets kv head h // G) in the
    encoder, the decoder and the cross-attention and in the cross cache,
    against one process at 1e-10 (and the reference)."""
    kw = {"n_kv_heads": 2}
    lay = api.GridLayout(_model("seamless_m4t_large_v2", **kw)[1],
                         _StandIn((1, 4)))
    assert (lay.tp_heads, lay.tp_kv) == (True, False)
    if mode == "train":
        tc, params, batch, one_m, one, jloss = _train_case(
            "seamless_m4t_large_v2", **kw)
        got = grid_train_steps(world, (1, 4), tc, params, batch, lr=LR)
        _hold_step(got, one_m, one)
        np.testing.assert_allclose(got["metrics"]["loss"], jloss, rtol=0,
                                   atol=STEP_LOSS_TOL)
        return
    case = _serve_case("seamless_m4t_large_v2", **kw)
    got = _run(world, (1, 4), case, mode == "seq")
    _hold_serve(got, one=case[5], ref=case[6]())
    assert got["cache_shapes"][0]["xk"][3] == 2      # every kv head


def _forward_columns(comm, device, *, cfg, params, batch):
    model = lm_params_from_reference(params, cfg, device=device, comm=comm)
    with torch.no_grad():
        logits, _ = api.forward(model, cfg, batch)
    return logits


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_cut_builds_the_rank_model(world, arch):
    """``interop.lm_params_from_reference(..., comm=)`` on (1, 2): the
    rank's model (an ``EncDecLM`` for seamless) from the reference's
    weights; its forward gives the rank's vocab columns of the one-process
    logits."""
    jc, tc, jparams, params = _model(arch)
    batch = _train_case(arch)[2]
    batch = {k: batch[k] for k in ("tokens", frontend_key(tc))}
    out = world.run_grid(_forward_columns, (1, 2), cfg=tc,
                         params=jax.tree.map(np.asarray, jparams),
                         batch=batch)
    whole, _ = api.forward(api.build_model(tc, params), tc,
                           {k: torch.as_tensor(v) for k, v in batch.items()})
    assert torch.allclose(torch.cat(out, dim=-1), whole, rtol=0, atol=1e-12)


# -------------------------------------------------------------- cache specs --

@pytest.mark.parametrize("seq_shard", [True, False], ids=["seq", "heads"])
@pytest.mark.parametrize("grid", [(2, 2), (16, 16)], ids=_gid)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_blocks_at_published_width(arch, grid, seq_shard):
    """``init_cache(..., grid=)`` and ``decode_specs`` at the published
    width, decode_32k's shape (meta tensors): the self k / v by positions
    (every kv head) or by kv heads, seamless's cross k / v of
    ``cross_frames(32768)`` = 8192 frames cut the same way."""
    cfg = tconfigs.get_config(arch)
    shape = tconfigs.SHAPES["decode_32k"]
    g = as_grid(grid)
    D, M = g["data"], g["model"]
    _, want, _, _ = I.decode_specs(cfg, shape, grid=grid,
                                   seq_shard=seq_shard)
    got = api.init_cache(cfg, shape.global_batch, shape.seq_len, "meta",
                         grid=grid, seq_shard=seq_shard)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == \
        jax.tree.map(lambda t: tuple(t.shape), want)
    B, hkv, dh = shape.global_batch // D, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    heads = hkv if seq_shard or hkv % M else hkv // M
    pos = shape.seq_len // M if seq_shard else shape.seq_len
    if cfg.family == "audio":
        body = got["decoder"]
        F = api.cross_frames(shape.seq_len)
        assert F == 8192
        assert tuple(body["xk"].shape) == (
            cfg.n_layers, B, F // M if seq_shard else F, heads, dh)
    else:
        body = got["blocks"]["sub0"]
    assert tuple(body["k"].shape) == (cfg.n_layers, B, pos, heads, dh)


@pytest.mark.parametrize("max_seq,grid", [(MAX_SEQ, (2, 2)),
                                          (ODD_MAX_SEQ, (1, 4))],
                         ids=["divides", "whole"])
def test_cut_cache_round_trip_on_the_audio_tree(max_seq, grid):
    """``cut_cache`` of a whole audio cache on every rank under both
    layouts: blocks of ``init_cache(..., grid=)``'s shapes that assemble
    into the whole (the cross frames cut over 'model' where
    ``cross_frames`` divides it, else whole)."""
    tc = tconfigs.get_reduced("seamless_m4t_large_v2")
    g = torch.Generator().manual_seed(0)
    frames = {"k": max_seq, "v": max_seq, "xk": api.cross_frames(max_seq),
              "xv": api.cross_frames(max_seq)}
    whole = {"decoder": {
        k: torch.randn((tc.n_layers, 4, n, tc.n_kv_heads,
                        tc.resolved_head_dim), generator=g)
        for k, n in frames.items()}}
    grid = as_grid(grid)
    for seq_shard in (True, False):
        blocks = [api.cut_cache(whole, tc, grid, coords_of(r, grid),
                                seq_shard) for r in range(grid_size(grid))]
        zeros = api.init_cache(tc, 4, max_seq, "cpu", grid=grid,
                               seq_shard=seq_shard)
        specs = api.cache_shardings(tc, 4, max_seq, grid, seq_shard)
        for k in ("k", "v", "xk", "xv"):
            assert blocks[0]["decoder"][k].shape == \
                zeros["decoder"][k].shape, k
            got = assemble([b["decoder"][k] for b in blocks],
                           specs["decoder"][k], grid)
            assert torch.equal(got, whole["decoder"][k]), k


# ---------------------------------------------------------------- launchers --

@pytest.mark.parametrize("arch", ARCHS)
def test_check_grid_family_accepts(arch):
    """The vlm and the audio family on every grid, with FSDP on or off."""
    for fsdp in (False, True):
        cfg = dataclasses.replace(tconfigs.get_reduced(arch), fsdp=fsdp)
        for grid in GRIDS + [(16, 16), (2, 16, 16)]:
            api.check_grid_family(cfg, as_grid(grid))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_on_a_grid(arch):
    """``launch.train --mesh 2x2`` (gloo CPU ranks): ``auto`` would pick
    plan_mesh's grid for the family; one step's finite loss (seamless on
    the frontend stub's encoder frames, llava on text alone)."""
    from repro_torch.launch.train import choose_layout, main
    assert choose_layout(tconfigs.get_reduced(arch), "auto", 4)[1] == \
        {"data": 1, "model": 4}
    hist = main(["--arch", arch, "--mesh", "2x2", "--device", "cpu",
                 "--steps", "1"])
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_feeds_the_frontend(arch):
    """The one-process ``Trainer``: seamless's batches carry the frontend
    stub's ``cross_frames(S)`` encoder frames (its encoder has no other
    input), llava's the stream's tokens alone, as the reference's Trainer
    feeds them (its ``S`` counts no prefix)."""
    from repro_torch.train import Trainer, TrainRunConfig
    cfg = tconfigs.get_reduced(arch)
    run = TrainRunConfig(steps=1, global_batch=2, seq_len=16, warmup=0,
                         log_every=1)
    trainer = Trainer(cfg, run, device="cpu")
    seen, step = [], trainer._step
    trainer._step = lambda state, batch: (
        seen.append({k: tuple(np.shape(v)) for k, v in batch.items()}),
        step(state, batch))[1]
    hist = trainer.run()
    assert np.isfinite(hist[0]["loss"])
    want = {k: (2, 16) for k in ("tokens", "labels", "mask")}
    if cfg.family == "audio":
        want["src_embeds"] = (2, api.cross_frames(16), cfg.d_model)
    assert seen == [want]


def test_serve_launcher_on_a_grid():
    """``launch.serve --mesh 2x2 --arch llava_next_34b`` serves text-only
    requests; seamless stays refused by the engine (its requests carry no
    encoder frames), with a mesh or without."""
    from repro_torch.launch.serve import main
    outs = main(["--arch", "llava_next_34b", "--mesh", "2x2", "--device",
                 "cpu", "--requests", "4", "--max-new", "3"])
    assert [len(o) for o in outs] == [3] * 4
    for mesh in ("none", "2x2"):
        with pytest.raises(ValueError, match="encoder"):
            main(["--arch", "seamless_m4t_large_v2", "--mesh", mesh,
                  "--device", "cpu"])
