"""The port's rule table (``repro_torch.models.sharding``), its production
grids (``launch/mesh.py``, ``train.elastic.plan_mesh``) and the dry run's
specs on them (``launch/inputs.py``, ``launch/dryrun.py --mesh``) against
the reference's.

The reference's ``make_rules`` reads nothing of a mesh but ``mesh.shape``,
so a stand-in with that mapping holds its rules on meshes of any size
without devices.  Everything here is a comparison of specs: exact.

* ``spec_for`` and the ``dropped`` audit on every leaf of every arch's
  parameter, optimizer (fsdp rule set) and decode-cache specs (with and
  without the ``cache_seq`` override), on grids (1, 1), (2, 2), (1, 4),
  (4, 1), (16, 16) and (2, 16, 16), fsdp on and off;
* the reference's six ``test_sharding_rules.py`` cases on the port;
* ``inputs``' rank shapes on ``16x16`` / ``2x16x16`` against the shard
  shapes of the reference's specs for every arch x shape, and a rank's
  train-state bytes at 16 x 16: 7.6 / 22.0 / 2.4 GB for dbrx / jamba /
  llama3.2-3b;
* the dry run's analytic records on both meshes (no cell fails);
* ``cut`` / ``assemble`` round trips, the replicas checked.
"""
import types

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import api as japi
from repro.models.sharding import make_rules as j_make_rules
from repro.optim import opt_state_specs as j_opt_state_specs
import repro_torch.configs as tconfigs
from repro_torch.launch import dryrun as D
from repro_torch.launch import inputs as I
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.core.grid import as_grid, coords_of, grid_size
from repro_torch.models.sharding import (assemble, cut, make_rules,
                                         shard_shape)
from repro_torch.optim import opt_state_specs
from repro_torch.train.elastic import plan_mesh

GRIDS = [(1, 1), (2, 2), (1, 4), (4, 1), (16, 16), (2, 16, 16)]
# a rank's train state at 16 x 16, GB, under the reference's rules
STATE_GB = {"dbrx_132b": 7.6, "jamba_1_5_large_398b": 22.0,
            "llama3_2_3b": 2.4}


def _mesh(grid) -> types.SimpleNamespace:
    """The reference's rules read ``mesh.shape`` alone."""
    return types.SimpleNamespace(shape=as_grid(grid))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _spec_trees(cfg, jcfg):
    """(name, port specs, reference specs) of the trees the rules cut."""
    p, j = api.param_specs(cfg), japi.param_specs(jcfg)
    yield "params", p, j
    yield "opt", opt_state_specs(p), j_opt_state_specs(j)
    yield "cache", api.init_cache_specs(cfg, 128, 32768), \
        japi.init_cache_specs(jcfg, 128, 32768)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "x".join(map(str, g)))
def test_specs_and_drops_match_the_reference(grid, fsdp):
    for arch in tconfigs.ARCH_IDS:
        cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
        for overrides in (None, {"cache_seq": ("model",)}):
            ours = make_rules(grid, fsdp=fsdp, overrides=overrides)
            theirs = j_make_rules(_mesh(grid), fsdp=fsdp,
                                  overrides=overrides)
            for name, p, j in _spec_trees(cfg, jcfg):
                got = {k: ours.spec_of(s) for k, s in _flat(p)}
                want = {k: tuple(theirs.spec_for(s.shape, s.axes))
                        for k, s in _flat(j)}
                assert got == want, (arch, name)
            assert ours.dropped == theirs.dropped, arch


# -- the reference's test_sharding_rules.py on the port ---------------------

def test_divisible_dim_sharded():
    assert make_rules((1, 1)).spec_for((32, 128), ("batch", "mlp")) == \
        ("data", "model")


def test_indivisible_dim_dropped():
    """14 heads on a 16-way model axis -> replicated, recorded."""
    rules = make_rules((1, 16))
    spec = rules.spec_for((896, 14, 64), ("embed", "heads", "head_dim"))
    assert spec == (None, None, None)
    assert any(d[0] == "heads" for d in rules.dropped)


def test_missing_mesh_axis_ignored():
    """'pod' is absent on the single-pod grid; batch falls back to
    'data'."""
    spec = make_rules((1, 1)).spec_for((32, 64), ("batch", "seq"))
    assert spec[0] in ("data", ("pod", "data"), ("data",))


def test_no_double_use_of_axis():
    spec = make_rules((1, 1)).spec_for((64, 64), ("mlp", "mlp"))
    assert len([s for s in spec if s is not None]) <= 1


def test_fsdp_rules_shard_embed():
    assert make_rules((1, 1), fsdp=True).spec_for(
        (128, 64), ("embed", "mlp")) == ("data", "model")
    assert make_rules((1, 1), fsdp=False).spec_for(
        (128, 64), ("embed", "mlp")) == (None, "model")


def test_overrides():
    rules = make_rules((1, 1), overrides={"cache_seq": ("model",)})
    spec = rules.spec_for((2, 64, 8, 16),
                          ("batch", "cache_seq", "kv_heads", "head_dim"))
    assert spec[1] == "model"


# -- grids, cuts and the production meshes ------------------------------------

def test_grid_coordinates_and_cuts():
    grid = as_grid((2, 2, 4))
    assert [tuple(coords_of(r, grid).values()) for r in range(16)] == \
        [(p, d, m) for p in range(2) for d in range(2) for m in range(4)]
    assert coords_of(6, grid) == {"pod": 0, "data": 1, "model": 2}
    t = torch.arange(8 * 12 * 3, dtype=torch.float64).reshape(8, 12, 3)
    spec = (("pod", "data"), "model", None)
    assert shard_shape(t.shape, spec, grid) == (2, 3, 3)
    blocks = [cut(t, spec, grid, coords_of(r, grid)).clone()
              for r in range(grid_size(grid))]
    assert torch.equal(assemble(blocks, spec, grid), t)
    assert np.array_equal(cut(t.numpy(), spec, grid, coords_of(5, grid)),
                          blocks[5].numpy())
    # replicated over 'model': its blocks must be the same bits
    blocks = [cut(t, (("pod", "data"), None, None), grid,
                  coords_of(r, grid)).clone() for r in range(16)]
    blocks[3][0, 0, 0] += 1
    with pytest.raises(RuntimeError, match="differ"):
        assemble(blocks, (("pod", "data"), None, None), grid)


def test_production_meshes_and_plan_mesh_match_the_reference(monkeypatch):
    import repro.train.elastic as j_elastic
    assert make_production_mesh() == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True) == \
        {"pod": 2, "data": 16, "model": 16}
    # the reference's arithmetic with its mesh constructor read back as a
    # grid (its mesh needs that many devices)
    monkeypatch.setattr(j_elastic.compat, "make_mesh",
                        lambda shape, axes: dict(zip(axes, shape)))
    for n in (1, 2, 3, 4, 6, 8, 12, 24, 64, 256, 512):
        for tp in (1, 2, 16):
            for pods in (None, 1, 2, 3):
                assert plan_mesh(n, tp, pods) == \
                    j_elastic.plan_mesh(n, tp, pods), (n, tp, pods)


# -- the dry run's specs on the production meshes -----------------------------

def _reference_shapes(cfg, shape, grid) -> dict:
    """The shard shapes of the reference's specs of a cell (its
    ``launch/inputs.py`` on the stand-in mesh)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        rules = j_make_rules(_mesh(grid), fsdp=cfg.fsdp,
                             overrides={"cache_seq": ("model",)})
    else:
        rules = j_make_rules(_mesh(grid), fsdp=cfg.fsdp)

    def shard(s, r=rules):
        return shard_shape(s.shape, tuple(r.spec_for(s.shape, s.axes)), grid)
    out = {}
    params = japi.param_specs(cfg)
    if shape.kind == "train":
        zero = j_make_rules(_mesh(grid), fsdp=True)
        opt = j_opt_state_specs(params)
        out.update({("params",) + k: shard(s) for k, s in _flat(params)})
        out.update({("opt",) + k: shard(s, zero) for k, s in _flat(opt)})
        out[("step",)] = ()
    else:
        out.update({("params",) + k: shard(s) for k, s in _flat(params)})
    if shape.kind == "decode":
        cache = japi.init_cache_specs(cfg, B, S)
        out.update({("cache",) + k: shard(s) for k, s in _flat(cache)})
        tok = shard_shape((B,), tuple(rules.spec_for((B,), ("batch",))),
                          grid)
        out[("tok",)] = out[("pos",)] = tok
        return out

    def batch(key, dims, axes):
        out[("batch", key)] = shard_shape(
            dims, tuple(rules.spec_for(dims, axes)), grid)
    if cfg.family == "audio":
        batch("src_embeds", (B, max(S // 4, 128), cfg.d_model),
              ("batch", "seq", "embed"))
        batch("tokens", (B, S), ("batch", "seq"))
        st = S
    elif cfg.family == "vlm":
        batch("extra_embeds", (B, cfg.frontend_tokens, cfg.d_model),
              ("batch", "seq", "embed"))
        st = S - cfg.frontend_tokens
        batch("tokens", (B, st), ("batch", "seq"))
    else:
        batch("tokens", (B, S), ("batch", "seq"))
        st = S
    if shape.kind == "train":
        batch("labels", (B, st), ("batch", "seq"))
        batch("mask", (B, st), ("batch", "seq"))
    return out


def _port_shapes(cfg, shape, grid) -> dict:
    if shape.kind == "train":
        state, b = I.train_specs(cfg, shape, grid=grid)
        tree = {"batch": b, **state}
    elif shape.kind == "prefill":
        params, b = I.prefill_specs(cfg, shape, grid=grid)
        tree = {"params": params, "batch": b}
    else:
        params, cache, tok, pos = I.decode_specs(cfg, shape, grid=grid)
        tree = {"params": params, "cache": cache, "tok": tok, "pos": pos}
    return {k: tuple(t.shape) for k, t in _flat(tree)}


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_rank_shapes_match_the_reference_on_the_production_meshes(mesh):
    grid = make_production_mesh(multi_pod=mesh == "multi")
    for arch in tconfigs.ARCH_IDS:
        cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
        for shape in tconfigs.SHAPES.values():
            assert _port_shapes(cfg, shape, grid) == \
                _reference_shapes(jcfg, shape, grid), (arch, shape.name)


def test_train_state_bytes_a_rank_at_16x16():
    grid = make_production_mesh()
    for arch, gb in STATE_GB.items():
        state, _ = I.train_specs(tconfigs.get_config(arch),
                                 tconfigs.SHAPES["train_4k"], grid=grid)
        assert round(I.tree_bytes(state) / 1e9, 1) == gb, arch
    # llama3.2-3b's 24 q and 8 kv heads do not divide model = 16
    rules = make_rules(grid)
    rules.tree(api.param_specs(tconfigs.get_config("llama3_2_3b")))
    assert {d[0] for d in rules.dropped} == {"heads", "kv_heads"}


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dryrun_records_on_the_production_meshes(tmp_path, mesh):
    grid = D.parse_mesh(mesh)
    recs = D.run(tconfigs.ARCH_IDS, list(tconfigs.SHAPES), probe=False,
                 out_dir=str(tmp_path), device="cpu", grid=grid)
    count = D.summarize(recs)
    assert count["failed"] == 0 and count["ok"] == 32
    by = {(r["arch"], r["shape"]): r for r in recs}
    for arch, gb in STATE_GB.items():
        r = by[(tconfigs.get_config(arch).name, "train_4k")]
        ma = r["memory_analysis"]
        assert r["mesh"] == "x".join(map(str, grid.values()))
        # arguments: the state and the rank's rows of the batch
        state, batch = I.train_specs(tconfigs.get_config(arch),
                                     tconfigs.SHAPES["train_4k"], grid=grid)
        assert ma["argument_bytes"] == I.tree_bytes(state) + \
            I.tree_bytes(batch)
        assert ma["alias_bytes"] == I.tree_bytes(state)
        assert abs(ma["alias_bytes"] / 1e9 - gb) < 0.06
    assert D.parse_mesh("4x2") == {"data": 4, "model": 2}
    assert D.parse_mesh("none") is None
    assert np.isfinite([r["memory_analysis"]["argument_bytes"]
                        for r in recs if r["status"] == "ok"]).all()
