"""The LM dry run and roofline of the port (``launch/inputs.py``,
``launch/dryrun.py``, ``launch/roofline.py``) against the reference's, on
the CPU.

* ``inputs``' meta specs at one rank equal the reference's
  ``ShapeDtypeStruct``s (built on a 1 x 1 ('data', 'model') mesh) in
  every leaf's path, shape and dtype, for every arch x shape; at four ranks
  the rank's shards tile the global shapes (a data-parallel rank's rows,
  a decode rank's sequence shard of every self-attention k / v, a rank's
  E / 4 experts of every MoE leaf).
* The probe's bilinear extrapolation on reduced configs (small shapes of
  the same names): its flops and bytes equal a direct count at the
  extrapolated size exactly (both are integer sums); an MoE decode
  differs exactly where its expert capacity rounds, as the record states.
* ``roofline.model_flops`` and ``analyze_cell`` equal the reference's on
  the same records, with the reference's TPU v5e constants passed in, for
  all 10 archs x 4 shapes (rtol 1e-12: the same float formulas).
* The dry run end to end at one and two ranks on the CPU.
"""
import jax
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import get_config as jget_config
from repro.launch import inputs as JI
from repro.launch import roofline as JR
from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeConfig, get_config,
                                 get_reduced)
from repro_torch.launch import dryrun as D
from repro_torch.launch import inputs as I
from repro_torch.launch import roofline as R
from repro_torch.models import api
from repro_torch.models.moe import is_expert_path

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]
SMALL = {"train_4k": ShapeConfig("train_4k", 64, 16, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 64, 8, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 64, 8, "decode"),
         "long_500k": ShapeConfig("long_500k", 128, 1, "decode")}
V5E = dict(peak_flops=JR.PEAK_FLOPS, hbm_bw=JR.HBM_BW, link_bw=JR.LINK_BW,
           hbm_capacity=16e9)


def _port_specs(cfg, shape, P):
    if shape.kind == "train":
        return I.train_specs(cfg, shape, P)
    if shape.kind == "prefill":
        return I.prefill_specs(cfg, shape, P)
    return I.decode_specs(cfg, shape, P)


def _flat_port(tree, path=()):
    if isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flat_port(v, path + (str(i),))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_port(tree[k], path + (k,))
    else:
        yield path, (tuple(tree.shape),
                     str(tree.dtype).removeprefix("torch."))


def _flat_ref(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = tuple(str(getattr(p, "idx", getattr(p, "key", p)))
                    for p in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


@pytest.fixture(scope="module")
def mesh():
    return compat.make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_specs_match_the_reference_at_one_rank(mesh, arch, shape_name):
    jcfg, shape = jget_config(arch), SHAPES[shape_name]
    if shape.kind == "train":
        ref = JI.train_specs(jcfg, shape, mesh)
    elif shape.kind == "prefill":
        ref = JI.prefill_specs(jcfg, shape, mesh)
    else:
        ref = JI.decode_specs(jcfg, shape, mesh)
    port = _port_specs(get_config(arch), shape, 1)
    got = dict(_flat_port(port))
    assert got == _flat_ref(ref)
    assert all(t.device.type == "meta"
               for t in jax.tree_util.tree_leaves(port))


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_rank_shards_tile_the_global_shapes(arch, shape_name):
    cfg, shape = get_config(arch), SHAPES[shape_name]
    whole = dict(_flat_port(_port_specs(cfg, shape, 1)))
    part = dict(_flat_port(_port_specs(cfg, shape, 4)))
    assert part.keys() == whole.keys()
    for path, (shp, dtype) in part.items():
        wshp, wdtype = whole[path]
        assert dtype == wdtype
        if shape.kind != "decode" and path[0] == "1":     # the batch
            assert (shp[0] * 4,) + shp[1:] == wshp, path
        elif shape.kind == "decode" and path[0] == "1" \
                and path[-1] in ("k", "v"):               # self-attn cache
            assert shp[:2] + (shp[2] * 4,) + shp[3:] == wshp, path
        elif is_expert_path(path):       # a rank's experts (layers, E / P)
            assert shp[:1] + (shp[1] * 4,) + shp[2:] == wshp, path
        else:
            assert shp == wshp, path
    assert I.tree_bytes(_port_specs(cfg, shape, 4)) <= \
        I.tree_bytes(_port_specs(cfg, shape, 1))


@pytest.fixture
def reduced(monkeypatch):
    """The dry run and the roofline on reduced configs at SMALL shapes."""
    monkeypatch.setattr(D, "get_config", get_reduced)
    monkeypatch.setattr(R, "get_config",
                        lambda name: get_reduced(name.removesuffix("-reduced")))
    monkeypatch.setattr(D, "SHAPES", {**D.SHAPES, **SMALL})
    monkeypatch.setattr(R, "SHAPES", {**R.SHAPES, **SMALL})


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
@pytest.mark.parametrize("arch", ["llama3_2_3b", "mamba2_370m",
                                  "seamless_m4t_large_v2",
                                  "jamba_1_5_large_398b", "phi3_5_moe_42b"])
def test_bilinear_extrapolation_equals_a_direct_count(reduced, tmp_path,
                                                      arch, shape_name):
    cfg, shape = get_reduced(arch), SMALL[shape_name]
    rec = D.probe_cell(arch, shape_name, 1, str(tmp_path), device="cpu")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["rows"] == {"probe": [2, 4], "full": D._share(shape, 1),
                           "sizing_from": 2}
    period = api._superblock_period(cfg)
    single = D._single_block(cfg, shape) and shape.kind != "decode"
    direct = D._rank_corner(
        None, "cpu", cfg=D._probe_cfg(cfg, cfg.n_layers, period, shape,
                                      single_block=single),
        shape=shape, rows=D._share(shape, 1), size=1, seq_shard=True,
        seed=0, timed=False)
    ex = rec["extrapolated_per_device"]
    slots = rec["moe_capacity_slots"]
    if slots is None or slots["exact"] == slots["extrapolated"]:
        assert (ex["flops"], ex["bytes_accessed"]) == \
            (direct["flops"], direct["bytes"])
    else:                       # the capacity rounds: the error is its slots
        assert ex["flops"] != direct["flops"]
    assert ex["step_s"] is None and ex["temp_bytes"] is None  # CPU


def test_cost_mode_counts_products_views_and_indexed_writes():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with D.CostMode() as m:
        c = a @ b
    assert m.flops == 2 * 8 * 16 * 4
    assert m.bytes == (a.numel() + b.numel() + c.numel()) * 4
    with D.CostMode() as m:
        a.view(16, 8).T.reshape(-1)[:3]
    assert (m.flops, m.bytes) == (0, 2 * 4 * 128)   # one copy: reshape of .T
    cache = torch.zeros(4, 1000, 8)
    rows, at, ones = torch.arange(4), torch.tensor([1, 2, 3, 4]), \
        torch.ones(4, 8)
    with D.CostMode() as m:
        cache[rows, at] = ones
    assert m.bytes == 2 * 4 * 8 * 4 + 2 * 4 * 8      # values + int64 indices


def _record(arch, shape_name, rng, with_probe: bool):
    """A dry-run record in the reference's format, with random numbers."""
    base = {"arch": arch, "shape": shape_name, "mesh": "single",
            "status": "ok", "chips": 256,
            "memory_analysis": {"argument_bytes": int(rng.integers(1e9, 2e10)),
                                "output_bytes": int(rng.integers(1e6, 1e9)),
                                "temp_bytes": int(rng.integers(1e8, 1e10))},
            "cost_analysis": {"flops_per_device": float(rng.uniform(1e12,
                                                                    1e16)),
                              "bytes_accessed_per_device":
                                  float(rng.uniform(1e9, 1e13))},
            "collectives": {"count": 10, "operand_bytes": 2e9,
                            "link_bytes": 3.9e9}}
    if not SHAPES[shape_name].applicable(get_config(arch))[0]:
        return {**{k: base[k] for k in ("arch", "shape", "mesh")},
                "status": "skipped", "reason": "full-attention arch"}, None
    probe = None
    if with_probe:
        probe = {"status": "ok", "extrapolated_per_device": {
            "flops": float(rng.uniform(1e13, 1e17)),
            "bytes_accessed": float(rng.uniform(1e10, 1e14)),
            "coll_count": 40.0, "coll_operand_bytes": float(rng.uniform(
                1e8, 1e11)), "coll_link_bytes": float(rng.uniform(1e8,
                                                                  1e11))}}
    return base, probe


@pytest.mark.parametrize("with_probe", [True, False],
                         ids=["probe", "rolled"])
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_roofline_matches_the_reference_on_its_records(arch, shape_name,
                                                       with_probe):
    rng = np.random.default_rng(abs(hash((arch, shape_name))) % 2 ** 32)
    base, probe = _record(arch, shape_name, rng, with_probe)
    assert R.model_flops(get_config(arch), SHAPES[shape_name]) == \
        JR.model_flops(jget_config(arch), SHAPES[shape_name])
    want = JR.analyze_cell(arch, shape_name, "single", base, probe)
    got = R.analyze_cell(arch, shape_name, "single", base, probe, **V5E)
    for key, value in want.items():
        if key == "advice":
            continue
        if key == "fits_16gb":
            assert got["fits"] == value
        elif isinstance(value, float):
            assert got[key] == pytest.approx(value, rel=1e-12), key
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("P", [1, 2])
def test_dry_run_end_to_end(reduced, tmp_path, P):
    world = D.open_world(P, "cpu")
    try:
        results = D.run(["llama3_2_3b", "mamba2_370m", "phi3_5_moe_42b"],
                        list(SMALL), P, str(tmp_path), device="cpu",
                        world=world)
    finally:
        if world is not None:
            world.close()
    count = D.summarize(results)
    assert count["failed"] == 0
    # long_500k: full attention skipped; MoE training probed on P > 1 too
    assert count["skipped"] == 2
    assert count["probes_skipped"] == 0
    cells = R.load_cells(str(tmp_path))
    assert len(cells) == 12
    for (arch, shape, mesh), slots in cells.items():
        assert mesh == f"p{P}" and "base" in slots
        row = R.analyze_cell(arch, shape, mesh, slots["base"],
                             slots.get("probe"))
        if row["status"] == "ok" and "compute_s" in row:
            assert row["measured_s"] is None          # not measured on a CPU
            assert row["wire"] == ("one rank: no wire" if P == 1 else
                                   "2 gloo ranks on the CPU")
    table = R.table(cells, f"p{P}")
    assert table.count("\n") == 13 and "FAILED" not in table
    llama = get_reduced("llama3_2_3b").name
    dec = cells[(llama, "decode_32k", f"p{P}")]["probe"]
    kinds = dec["extrapolated_per_device"]["by_kind"]
    layers = get_reduced("llama3_2_3b").n_layers
    if P == 1:
        assert kinds == {}
    else:       # flash-decoding: one max and one sum a layer
        assert {k: v["count"] for k, v in kinds.items()} == \
            {"all_reduce": layers, "max": layers}
        train = cells[(llama, "train_4k", "p2")]["base"]
        assert train["collectives"]["count"] == 2    # gradients and loss
        # the experts sharded over the ranks: a layer's forward gathers the
        # counts and sums the router's probabilities, two all-to-alls
        # there and two in backward, which also all-reduces the sums'
        # gradient; then the gradients (bf16 and the f32 router), the
        # loss and the shards' squared norm
        moe_cfg = get_reduced("phi3_5_moe_42b")
        moe_train = cells[(moe_cfg.name, "train_4k", "p2")]
        kinds = moe_train["probe"]["extrapolated_per_device"]["by_kind"]
        n = moe_cfg.n_layers
        assert {k: v["count"] for k, v in kinds.items()} == \
            {"all_gather": n, "all_to_all": 4 * n, "all_reduce": 2 * n + 4}
        assert "2 of 4 a rank" in moe_train["base"]["reduced"]["experts"]


def test_a_probe_that_cannot_fit_is_skipped_with_its_gb(reduced, tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(D, "_budget", lambda *a: 1e3)
    rec = D.probe_cell("llama3_2_3b", "train_4k", 1, str(tmp_path),
                       device="cpu")
    assert rec["status"] == "skipped" and "GB" in rec["reason"]
    base = D.run_cell("llama3_2_3b", "train_4k", 1, str(tmp_path),
                      device="cpu", probe=rec, verbose=False)
    assert base["status"] == "ok" and base["cost_analysis"] is None
    assert base["memory_analysis"]["temp_source"] == "not measured"
    row = R.analyze_cell("llama3_2_3b", "train_4k", "p1", base, rec)
    assert row["cost_source"].startswith("not measured")


def test_analytic_record_at_production_size_allocates_nothing(tmp_path):
    rec = D.run_cell("llama3_2_3b", "decode_32k", 1, str(tmp_path),
                     device="cpu", verbose=False)
    mem = rec["memory_analysis"]
    cfg = get_config("llama3_2_3b")
    cache = 2 * cfg.n_layers * 128 * 32768 * cfg.n_kv_heads * \
        cfg.resolved_head_dim * 2
    assert mem["alias_bytes"] == cache            # 481 GB, updated in place
    assert mem["argument_bytes"] > cache
    assert mem["temp_bytes"] is None


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "qwen2_0_5b",
                                     "--shape", "decode_32k", "--probe"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.main()
