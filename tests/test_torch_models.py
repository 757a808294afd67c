"""The port's model layer (``repro_torch.configs``, ``repro_torch.models``,
``repro_torch.data.tokens``) against the reference's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
reference's weights reach the port through
``interop.lm_params_from_reference``.  Tolerances, all f32:
* the layers (rmsnorm, chunked and decode attention): atol 2e-5 on values
  of order 1 (XLA and ATen round exp and sum in their own ways);
* rope: atol 1e-4 at positions below 300.  The two packages' exp can round
  a frequency one f32 ulp apart (6e-8 relative), which moves the angle at
  position 300 by up to 2e-5 and the rotated value by as much (3.6e-5
  read at theta 5e5);
* ``forward`` on the reduced configs: atol 3e-3 on logits of order 5.  Held
  against an f64 forward of the same weights, the port reads 6e-5 to 9e-5
  and the reference up to 1.3e-3 (qwen2, its rope and exp at theta 1e6), so
  the gate is the reference's own f32 error with room.
In f64 the port's layers compute in f64 throughout (the reference keeps
norms, rope and the softmax in f32 whatever its inputs): held against numpy
in f64 at atol 1e-12 on values of order 1 (a few hundred f64 ulps).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data import TokenStream as JStream
from repro.data import synthetic_lm_batch as j_batch
from repro.models import api as japi
from repro.models import init_params as jinit
from repro.models import layers as JL
from repro.models.module import param_bytes as j_param_bytes
import repro_torch.configs as tconfigs
from repro_torch.data import TokenStream, synthetic_lm_batch
from repro_torch.interop import lm_params_from_reference
from repro_torch.models import DecoderLM, api, init_params
from repro_torch.models import layers as TL
from repro_torch.models.module import ParamSpec, param_bytes

ARCHS = ["llama3_2_3b", "mistral_nemo_12b", "qwen2_0_5b", "granite_3_2b",
         "llava_next_34b", "mamba2_370m", "seamless_m4t_large_v2",
         "jamba_1_5_large_398b", "dbrx_132b", "phi3_5_moe_42b"]
LAYER_TOL = 2e-5
ROPE_TOL = 1e-4
LOGIT_TOL = 3e-3


def _same_fields(t, j):
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert str(a).split(".")[-1] == jnp.dtype(b).name
        elif dataclasses.is_dataclass(b):     # the moe / ssm sub-configs
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_counts_match_reference(arch):
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    _same_fields(t, j)
    _same_fields(tconfigs.get_reduced(arch), jconfigs.get_reduced(arch))
    assert tconfigs.n_params(t) == jconfigs.n_params(j)
    assert tconfigs.n_active_params(t) == jconfigs.n_active_params(j)
    assert param_bytes(api.param_specs(t)) == j_param_bytes(
        japi.param_specs(j))
    assert t.padded_vocab == j.padded_vocab


def test_registry_matches_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    assert {k: dataclasses.astuple(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}
    cfg = tconfigs.get_config("llama3.2-3b")
    assert tconfigs.n_params(cfg) == 3212749824
    assert param_bytes(api.param_specs(cfg)) == 6425499648


def test_init_params_follows_the_specs():
    tree = {"w": ParamSpec((3, 4), ("a", "b"), torch.float32),
            "z": ParamSpec((5,), ("a",), torch.bfloat16, init="zeros"),
            "o": ParamSpec((2,), ("a",), torch.float32, init="ones"),
            "e": ParamSpec((7, 6), ("a", "b"), torch.bfloat16, scale=0.5)}
    p = init_params(tree, torch.Generator().manual_seed(0))
    q = init_params(tree, torch.Generator().manual_seed(0))
    for k, s in tree.items():
        assert p[k].shape == s.shape and p[k].dtype == s.dtype
        assert torch.equal(p[k], q[k])
    assert torch.equal(p["z"], torch.zeros(5, dtype=torch.bfloat16))
    assert torch.equal(p["o"], torch.ones(2))
    assert 0.1 < float(p["w"].std()) < 1.2          # 1/sqrt(fan_in = 3)
    cfg = tconfigs.get_reduced("llama3_2_3b")
    model = DecoderLM.init(cfg, torch.Generator().manual_seed(0))
    assert len(model.layers) == cfg.n_layers
    assert sum(p.numel() for p in model.parameters()) == tconfigs.n_params(cfg)
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("theta", [1e4, 5e5, 1e6])
def test_rmsnorm_and_rope_match_reference(theta):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 37, 4, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 37))
    np.testing.assert_allclose(
        TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        rtol=0, atol=LAYER_TOL)
    np.testing.assert_allclose(
        TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy(),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)),
        rtol=0, atol=ROPE_TOL)


F64_TOL = 1e-12


def _np_attention(q, k, v, q_offset, causal):
    """softmax(q k^T / sqrt(Dh)) v in numpy f64, query head h on key head
    h // G."""
    B, Sq, H, Dh = q.shape
    G = H // k.shape[2]
    kk, vv = np.repeat(k, G, axis=2), np.repeat(v, G, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(Dh)
    if causal:
        qpos = q_offset + np.arange(Sq)[:, None]
        s = np.where(np.arange(k.shape[1])[None, :] <= qpos, s, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, vv)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Skv,q_offset", [(37, 37, 0), (19, 50, 31)])
def test_layers_run_in_f64_for_f64_inputs(Sq, Skv, q_offset, causal):
    """rmsnorm, rope, chunked and decode attention of f64 inputs against
    numpy in f64: no f32 step inside."""
    rng = np.random.default_rng(Sq + Skv)
    q = rng.standard_normal((2, Sq, 4, 16))
    k = rng.standard_normal((2, Skv, 2, 16))
    v = rng.standard_normal((2, Skv, 2, 16))
    w = rng.standard_normal(16)
    t = torch.from_numpy
    ms = np.mean(q * q, axis=-1, keepdims=True)
    got = TL.rmsnorm(t(q), t(w))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), q / np.sqrt(ms + 1e-5) * w,
                               rtol=0, atol=F64_TOL)
    pos = rng.integers(0, 300, size=(2, Sq))
    ang = pos[..., None] * np.exp(-np.log(1e4) * np.arange(8) / 8)
    cos, sin = np.cos(ang)[:, :, None], np.sin(ang)[:, :, None]
    x1, x2 = q[..., :8], q[..., 8:]
    np.testing.assert_allclose(
        TL.rope(t(q), t(pos), 1e4).numpy(),
        np.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1),
        rtol=0, atol=F64_TOL)
    got = TL.chunked_attention(t(q), t(k), t(v), q_offset=q_offset,
                               causal=causal, block_q=16, block_kv=32)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(),
                               _np_attention(q, k, v, q_offset, causal),
                               rtol=0, atol=F64_TOL)
    last = Sq - 1 + q_offset                  # one decode step at each row
    got = TL.decode_attention(t(q[:, -1:]), t(k), t(v),
                              torch.tensor([last, last]))
    want = _np_attention(q[:, -1:], k[:, :last + 1], v[:, :last + 1],
                         last, True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F64_TOL)


@pytest.mark.parametrize("Sq,Skv,q_offset", [(37, 37, 0), (5, 70, 65),
                                              (64, 64, 0), (19, 50, 31)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv", [(4, 2), (6, 1), (3, 3)])
def test_chunked_attention_matches_reference(Sq, Skv, q_offset, causal, H,
                                             Hkv):
    """Ragged lengths (padded to blocks of 16 queries and 32 keys), GQA
    groups of 1-6 heads, causal and not, queries offset into the keys."""
    rng = np.random.default_rng(Sq * Skv + H)
    q = rng.standard_normal((2, Sq, H, 16)).astype(np.float32)
    k = rng.standard_normal((2, Skv, Hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, Skv, Hkv, 16)).astype(np.float32)
    kw = {"q_offset": q_offset, "causal": causal, "block_q": 16,
          "block_kv": 32}
    got = TL.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LAYER_TOL)


@pytest.mark.parametrize("H,Hkv", [(4, 2), (8, 8)])
def test_decode_attention_matches_reference_per_slot(H, Hkv):
    """Each slot attends to its own prefix of the cache (pos per slot)."""
    rng = np.random.default_rng(H)
    q = rng.standard_normal((3, 1, H, 16)).astype(np.float32)
    ck = rng.standard_normal((3, 40, Hkv, 16)).astype(np.float32)
    cv = rng.standard_normal((3, 40, Hkv, 16)).astype(np.float32)
    pos = np.array([0, 17, 39], np.int32)
    got = TL.decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                              torch.from_numpy(cv), torch.from_numpy(pos))
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(ck),
                               jnp.asarray(cv), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LAYER_TOL)


def _f32(get, arch):
    cfg = get(arch)
    f32 = torch.float32 if get is tconfigs.get_reduced else jnp.float32
    return dataclasses.replace(cfg, dtype=f32, param_dtype=f32)


def shared_model(arch, seed=0):
    """(reference cfg, reference params, port cfg, port model) with the
    reference's weights, f32."""
    jc, tc = _f32(jconfigs.get_reduced, arch), _f32(tconfigs.get_reduced,
                                                     arch)
    params = jinit(japi.param_specs(jc), jax.random.key(seed))
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), tc,
                                     device="cpu")
    return jc, params, tc, model


@pytest.mark.parametrize("arch", ["llama3_2_3b", "qwen2_0_5b",
                                  "granite_3_2b", "llava_next_34b",
                                  "mamba2_370m", "jamba_1_5_large_398b",
                                  "phi3_5_moe_42b", "dbrx_132b",
                                  "seamless_m4t_large_v2"])
def test_forward_matches_reference(arch):
    jc, params, tc, model = shared_model(arch)
    if tc.qkv_bias:   # zero-initialised: give the biases values
        rng = np.random.default_rng(1)
        for layer_p in (params["blocks"]["sub0"]["attn"],):
            for b in ("bq", "bk", "bv"):
                layer_p[b] = jnp.asarray(0.1 * rng.standard_normal(
                    layer_p[b].shape).astype(np.float32))
        model = lm_params_from_reference(jax.tree.map(np.asarray, params),
                                         tc, device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tc.vocab, size=(2, 45)).astype(np.int32)
    batch = {"tokens": toks}
    if tc.family == "vlm":
        batch["extra_embeds"] = (0.1 * rng.standard_normal(
            (2, tc.frontend_tokens, tc.d_model))).astype(np.float32)
    if tc.family == "audio":
        batch["src_embeds"] = (0.1 * rng.standard_normal(
            (2, 16, tc.d_model))).astype(np.float32)
    want, jaux = japi.forward(params, jc, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    got, aux = api.forward(model, tc, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    assert got.shape == want.shape == (2, 45 + tc.frontend_tokens,
                                       tc.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)
    # the MoE metrics, summed over the MoE layers
    assert aux.keys() == jaux.keys()
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("arch", ["mamba2_370m", "jamba_1_5_large_398b",
                                  "phi3_5_moe_42b", "seamless_m4t_large_v2"])
def test_param_tree_round_trips_every_body(arch):
    """The model keeps the reference's stacked layout (``blocks/sub{j}`` or
    ``encoder`` / ``decoder``) whatever its layers hold: its parameter tree
    equals the reference's, leaf for leaf, and a cast keeps the f32
    parameters f32."""
    _, params, tc, model = shared_model(arch)

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        else:
            yield path, np.asarray(tree)

    got, want = dict(leaves(model.param_tree())), dict(leaves(params))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    assert sum(p.numel() for p in model.parameters()) == \
        tconfigs.n_params(tc)
    layers = model.dec_layers if tc.family == "audio" else model.layers
    kinds = [layer.kinds for layer in layers]
    assert len(kinds) == tc.n_layers
    if tc.family == "hybrid":       # attention mid-period, MoE every other
        assert [("attn" in k, "moe" in k) for k in kinds[:8]] == [
            (i == 4, i % 2 == 1) for i in range(8)]
    bf = model.cast(torch.bfloat16)
    for name, t in bf.named_parameters():
        f32 = name.rsplit(".", 1)[-1] in ("A_log", "D", "dt_bias", "router")
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), name


def test_token_stream_matches_reference():
    for kw in ({"vocab": 256, "seq_len": 128, "global_batch": 8},
               {"vocab": 128256, "seq_len": 33, "global_batch": 4,
                "seed": 7, "host_index": 1, "num_hosts": 2}):
        a, b = TokenStream(**kw), JStream(**kw)
        for _ in range(3):
            x, y = next(a), next(b)
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
        assert a.state_dict() == b.state_dict()
    x, y = synthetic_lm_batch(256, 128, 8, seed=3), j_batch(256, 128, 8,
                                                            seed=3)
    for k in x:
        np.testing.assert_array_equal(x[k], y[k])
