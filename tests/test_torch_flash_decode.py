"""Flash-decoding over a sequence-sharded cache
(``models.layers.decode_attention_seqsharded``) and decode on a sharded
cache (``models.api.decode_step(..., comm=...)``), on one module world of
four gloo CPU ranks.

* Flash-decoding against the reference's dense
  ``repro.models.layers.decode_attention`` -- the oracle of the
  reference's own check (``tests/dist_checks.py``, ``check_flash_decode``)
  -- on its numpy inputs (B = 2, S = 64, H = 8, Hkv = 4, Dh = 16, pos =
  [37, 11]) on P in {2, 4} ranks: 1e-5 (the reference's bar) in f32 and in
  f64, since the reference takes its scores and softmax statistics in f32
  whatever the inputs (``preferred_element_type``); in f64 also against
  the port's own dense ``decode_attention``, which runs in f64
  (``layers.acc_dtype``), at 1e-12 (the shards regroup the softmax sums;
  f64's unit is 2^29 f32's).
  Each call makes exactly two all-reduces (one max, one sum) of fewer
  bytes than a quarter of the cache (the reference's assertion).
* Greedy decode steps on the shards against the local ``decode_step`` on
  the whole cache, reduced llama (dense), jamba (the mamba state
  replicated) and seamless (the cross cache whole), f32: tokens equal,
  logits within 1e-4 (the flash combination regroups f32 sums; the
  differences seen are 1e-6 - 2e-5), a shard boundary crossed, two
  all-reduces per attention layer a step, and the shards, put together,
  the local cache (a row written on the wrong rank shows there).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.configs import get_reduced
from repro_torch.core import SolverWorld
from repro_torch.core.collectives import collective_summary
from repro_torch.launch import flash_decode as F
from repro_torch.models import api
from repro_torch.models import layers as tlayers

from _x64 import x64_mode  # noqa: F401  (autouse fixture)

B, S, H, HKV, DH = 2, 64, 8, 4, 16
POS = np.array([37, 11], np.int32)
TOL = 1e-5           # against the reference (f32 statistics in both dtypes)
TOL_F64 = 1e-12      # f64 against the port's f64 dense decode attention
DECODE_TOL = 1e-4


@pytest.fixture(scope="module")
def world():
    with SolverWorld(4, device="cpu", kernels=False, timeout=120) as w:
        yield w


def _inputs(dtype):
    rng = np.random.default_rng(0)
    return [rng.standard_normal(shape).astype(dtype)
            for shape in ((B, 1, H, DH), (B, S, HKV, DH), (B, S, HKV, DH))]


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("P", [2, 4])
def test_flash_decoding_matches_the_reference_dense_attention(world, P,
                                                              dtype):
    q, ck, cv = _inputs(dtype)
    dense = np.asarray(jlayers.decode_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(POS)))
    got = F.flash_decode(world, *(torch.from_numpy(a) for a in (q, ck, cv)),
                         torch.from_numpy(POS), P)
    assert got["out"].dtype == torch.from_numpy(q).dtype
    np.testing.assert_allclose(got["out"].numpy(), dense, rtol=TOL, atol=TOL)
    if dtype == np.float64:
        own = tlayers.decode_attention(*(torch.from_numpy(a)
                                         for a in (q, ck, cv)),
                                       torch.from_numpy(POS))
        np.testing.assert_allclose(got["out"].numpy(), own.numpy(),
                                   rtol=TOL_F64, atol=TOL_F64)
    cache_bytes = ck.nbytes + cv.nbytes
    for c in got["counters"]:
        summ = collective_summary(c)
        assert c["all_reduces"] == 2 and c["max_reduces"] == 1
        assert summ.by_kind == {"all_reduce": (1, B * HKV * (H // HKV)
                                               * (DH + 1)),
                                "max": (1, B * HKV * (H // HKV))}
        assert c["hops"] == 0 and c["bytes"] < cache_bytes / 4


def test_a_shard_wholly_after_pos_is_removed_by_its_rescale(world):
    """Every key of shards 1-3 lies after both rows' positions: their m is
    NEG_INF and p = 1 on every key; only the rescale r = 0 removes them."""
    q, ck, cv = _inputs(np.float64)
    pos = np.array([5, 15], np.int32)
    dense = np.asarray(jlayers.decode_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos)))
    args = [torch.from_numpy(a) for a in (q, ck, cv, pos)]
    got = F.flash_decode(world, *args, 4)
    np.testing.assert_allclose(got["out"].numpy(), dense, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["out"].numpy(),
                               tlayers.decode_attention(*args).numpy(),
                               rtol=TOL_F64, atol=TOL_F64)


def test_sharded_cache_specs_cut_only_the_self_attention_sequence():
    for arch in ("llama3_2_3b", "jamba_1_5_large_398b",
                 "seamless_m4t_large_v2"):
        cfg = get_reduced(arch)
        whole = api.init_cache(cfg, 2, 64, "cpu")
        for r in range(4):
            part = api.shard_cache(whole, cfg, r, 4)
            want = api.init_cache_specs(cfg, 2, 64, seq_shards=4)
            for g, tree in want.items():
                for k, v in tree.items():
                    leaves = v if isinstance(v, dict) else {k: v}
                    got = part[g][k] if isinstance(v, dict) else part[g]
                    for name, spec in leaves.items():
                        t = got[name]
                        assert tuple(t.shape) == spec.shape, (arch, name)
                        assert t.dtype == spec.dtype
    with pytest.raises(ValueError, match="does not split"):
        api.init_cache_specs(get_reduced("llama3_2_3b"), 2, 65, seq_shards=4)


def _stitch(caches: list) -> dict:
    """The ranks' shards put back together along the sequence."""
    def cat(name, parts):
        return torch.cat(parts, dim=2) if name in ("k", "v") else parts[0]

    out = {}
    for g, tree in caches[0].items():
        out[g] = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[g][k] = {n: cat(n, [c[g][k][n] for c in caches])
                             for n in v}
            else:
                out[g][k] = cat(k, [c[g][k] for c in caches])
    return out


def _leaves(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("arch", ["llama3_2_3b", "jamba_1_5_large_398b",
                                  "seamless_m4t_large_v2"])
def test_decode_on_the_sharded_cache_matches_the_local_decode(world, arch):
    cfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32,
                              param_dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    model = api.init_model(cfg, gen)
    prompt, max_seq, steps = 29, 64, 6      # positions 29..34 cross 32
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, prompt),
                                     generator=gen)}
    if cfg.family == "audio":
        batch["src_embeds"] = 0.1 * torch.randn(2, 16, cfg.d_model,
                                                generator=gen)
    with torch.no_grad():
        logits, cache = api.prefill(model, cfg, batch, max_seq=max_seq)
    tok = logits[:, :cfg.vocab].argmax(-1)
    pos = torch.tensor([prompt, prompt + 2])
    whole = {g: dict(_clone(t)) for g, t in cache.items()}
    local = F.local_decode(model, cfg, whole, tok, pos, steps)
    got = F.sharded_decode(world, cfg, model.param_tree(), cache, tok, pos,
                           steps, 4)
    assert torch.equal(got["tokens"], local["tokens"])
    np.testing.assert_allclose(got["logits"].numpy(),
                               local["logits"].numpy(), rtol=0,
                               atol=DECODE_TOL)
    attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    assert got["all_reduces"] == [2 * attn] * steps
    stitched = _stitch(got["caches"])
    for (path, a), (_, b) in zip(_leaves(stitched), _leaves(whole)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=DECODE_TOL, err_msg=str(path))


def _clone(tree):
    for k, v in tree.items():
        yield k, (v.clone() if torch.is_tensor(v) else dict(_clone(v)))


def test_max_all_reduce_is_counted_and_refused_on_a_solver_path():
    """``Comm``'s max counts among its all-reduces and as the kind
    ``"max"``, which the contract pass's check refuses where a solver
    declares only sums."""
    from repro_torch.analysis.contract_pass import _check_record
    rec = {"all_reduces": 3, "words": 12, "max_reduces": 1, "max_words": 2,
           "hops": 0, "hop_words": 0}
    summ = collective_summary(rec)
    assert summ.by_kind == {"all_reduce": (2, 10), "max": (1, 2)}
    violations = []
    _check_record(summ, ("all_reduce",), 2, "case", violations)
    assert [v.check for v in violations] == ["collective-kind"]


def test_entry_point_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        F.main(device="cuda")


def test_wire_tap_records_a_max_all_reduce():
    import torch.distributed as dist
    from repro_torch.core.collectives import WireTap
    tap = WireTap()
    t = torch.zeros(6)
    tap._count("all_reduce", (t,), {"op": dist.ReduceOp.MAX})
    tap._count("all_reduce", (t,), {})
    c = tap.counters()
    assert (c["all_reduces"], c["max_reduces"], c["max_words"]) == (2, 1, 6)
    assert collective_summary(c).by_kind == {"all_reduce": (1, 6),
                                             "max": (1, 6)}
