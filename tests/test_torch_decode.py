"""The port's serving path (``models.api.prefill`` / ``decode_step`` and
``serve.engine.Engine``) against the reference's, on the CPU in f32, on the
reference's weights (``interop.lm_params_from_reference``) and, for
``decode_step``, the reference's cache (``interop.lm_cache_from_reference``).

Tolerances: logits and cache entries of the two packages, atol 3e-3 (the
reference's own f32 error on these configs, ``test_torch_models.py``);
prefill + decode against forward inside one package, rtol / atol 1e-3 (the
reference's ``tests/test_decode.py``), and 1e-10 for the model cast to f64
(f64's unit is 2^29 times f32's).  Greedy tokens are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as japi
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.data import synthetic_lm_batch
from repro_torch.interop import lm_cache_from_reference, lm_cache_to_numpy
from repro_torch.models import api
from repro_torch.serve import Engine, ServeConfig

from test_torch_models import LOGIT_TOL, shared_model


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


# tests/test_decode.py's archs: every body and every family but dense's
# twins (granite, mistral-nemo) and dbrx (phi3.5's body)
ARCHS = ["llama3_2_3b", "qwen2_0_5b", "mamba2_370m", "jamba_1_5_large_398b",
         "seamless_m4t_large_v2", "phi3_5_moe_42b", "llava_next_34b"]


def _extra(cfg, B, seed=1) -> dict:
    """The inputs beside the tokens: the vlm's patch embeddings, the audio
    family's encoder frames (16 of them)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"extra_embeds": (0.1 * rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)}
    if cfg.family == "audio":
        return {"src_embeds": (0.1 * rng.standard_normal(
            (B, 16, cfg.d_model))).astype(np.float32)}
    return {}


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step_match_reference(arch):
    jc, params, tc, model = shared_model(arch)
    B, S, max_seq = 2, 21, 40
    toks = np.random.default_rng(3).integers(0, tc.vocab, size=(B, S))
    toks = toks.astype(np.int32)
    extra = _extra(tc, B)
    lj, cj = japi.prefill(params, jc, {"tokens": jnp.asarray(toks)} | {
        k: jnp.asarray(v) for k, v in extra.items()}, max_seq=max_seq)
    lt, ct = api.prefill(model, tc, {"tokens": torch.from_numpy(toks)} | {
        k: torch.from_numpy(v) for k, v in extra.items()}, max_seq=max_seq)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGIT_TOL)
    for a, b in zip(_leaves(lm_cache_to_numpy(ct)), _leaves(cj)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_TOL)
    # one step from the reference's own cache, per-slot positions
    cache = jax.tree.map(np.asarray, cj)
    tok = np.array([3, 250], np.int32)
    pos = np.array([S, S - 4], np.int32)
    dj, nj = japi.decode_step(params, jc, cj, jnp.asarray(tok),
                              jnp.asarray(pos))
    dt, nt = api.decode_step(model, tc,
                             lm_cache_from_reference(cache, device="cpu",
                                                     dtype=torch.float32),
                             torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                               atol=LOGIT_TOL)
    for a, b in zip(_leaves(lm_cache_to_numpy(nt)), _leaves(nj)):
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS + ["granite_3_2b", "dbrx_132b"])
def test_prefill_decode_equals_forward(arch):
    """Inside the port: prefill of S - 1 tokens and one decode step give
    forward's logits at positions S - 2 and S - 1 (the vlm's prefix: prefill
    only, as the reference's test)."""
    _, _, cfg, model = shared_model(arch)
    B, S = 2, 32
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_lm_batch(cfg.vocab, S, B).items()}
    batch |= {k: torch.from_numpy(v) for k, v in _extra(cfg, B).items()}
    full, _ = api.forward(model, cfg, batch)
    P = full.shape[1] - S                   # prefix positions
    pre = dict(batch, tokens=batch["tokens"][:, :S - 1])
    logits_pre, cache = api.prefill(model, cfg, pre, max_seq=P + S)
    torch.testing.assert_close(logits_pre, full[:, P + S - 2], rtol=1e-3,
                               atol=1e-3)
    if cfg.family == "vlm":
        return
    logits_dec, _ = api.decode_step(model, cfg, cache, batch["tokens"][:, -1],
                                    torch.full((B,), S - 1))
    torch.testing.assert_close(logits_dec, full[:, S - 1], rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("arch", ["llama3_2_3b", "qwen2_0_5b"])
def test_f64_prefill_decode_equals_forward(arch):
    """The model cast to f64 runs in f64 (``models.layers.acc_dtype``):
    prefill + decode against forward within 1e-10, and its logits within
    the f32 gate of the f32 model's."""
    _, _, cfg, model = shared_model(arch)
    model64 = model.cast(torch.float64)
    cfg64 = model64.cfg
    B, S = 2, 24
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_lm_batch(cfg.vocab, S, B).items()}
    full, _ = api.forward(model64, cfg64, batch)
    assert full.dtype == torch.float64
    torch.testing.assert_close(full.float(), api.forward(model, cfg, batch)[0],
                               rtol=0, atol=LOGIT_TOL)
    pre = dict(batch, tokens=batch["tokens"][:, :S - 1])
    logits_pre, cache = api.prefill(model64, cfg64, pre, max_seq=S)
    logits_dec, _ = api.decode_step(model64, cfg64, cache,
                                    batch["tokens"][:, -1],
                                    torch.full((B,), S - 1))
    torch.testing.assert_close(logits_pre, full[:, S - 2], rtol=0,
                               atol=1e-10)
    torch.testing.assert_close(logits_dec, full[:, S - 1], rtol=0,
                               atol=1e-10)


def test_engine_matches_stepwise_oracle_and_reference():
    """The engine's greedy tokens equal the step-by-step greedy forward and
    the reference engine's on the same weights (2 slots, 2 prompts)."""
    jc, params, tc, model = shared_model("llama3_2_3b")
    prompts = [[5, 6, 7, 8], [1, 2, 3]]
    eng = Engine(tc, model, ServeConfig(max_seq=128, slots=2, min_bucket=16))
    outs = eng.generate(prompts, max_new=8)
    toks = list(prompts[0])
    for _ in range(8):
        logits, _ = api.forward(model, tc, {"tokens": torch.tensor([toks])})
        toks.append(int(torch.argmax(logits[0, -1, :tc.vocab])))
    assert outs[0] == toks[4:]
    assert [len(o) for o in outs] == [8, 8]
    jeng = JEngine(jc, params, JServeConfig(max_seq=128, slots=2,
                                            min_bucket=16))
    assert outs == jeng.generate(prompts, max_new=8)


def test_engine_queues_more_requests_than_slots_like_reference():
    """Five prompts of mixed length (three prefill buckets) through two
    slots: every request completes, with the reference engine's tokens."""
    jc, params, tc, model = shared_model("qwen2_0_5b")
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(1, tc.vocab, size=n)))
               for n in (3, 17, 9, 40, 1)]
    sc = {"max_seq": 96, "slots": 2, "min_bucket": 8}
    eng = Engine(tc, model, ServeConfig(**sc))
    outs = eng.generate(prompts, max_new=6)
    assert [len(o) for o in outs] == [6] * 5
    assert not eng.active.any() and not eng.queue
    jouts = JEngine(jc, params, JServeConfig(**sc)).generate(prompts,
                                                             max_new=6)
    assert outs == jouts


def test_engine_samples_from_its_own_stream():
    """Temperature sampling draws from the engine's generator: the same
    seed gives the same tokens, another seed other tokens."""
    _, _, tc, model = shared_model("llama3_2_3b")

    def run(seed):
        eng = Engine(tc, model, ServeConfig(max_seq=64, slots=2,
                                            temperature=1.0, seed=seed))
        return eng.generate([[5, 6, 7], [9]], max_new=12)

    assert run(0) == run(0)
    assert run(0) != run(1)
    assert all(0 <= t < tc.vocab for o in run(2) for t in o)


# f64 models of the families with f32 islands (the reference's casts):
# mamba's scan and state, the MoE router and combine.  Prefill + decode
# against forward: atol 1e-5 on logits of order 5 (the islands round in f32,
# about 1e-6 read), and the f64 model's logits within the f32 gate of the
# f32 model's.
ISLAND_TOL = 1e-5


@pytest.mark.parametrize("arch", ["mamba2_370m", "jamba_1_5_large_398b",
                                  "phi3_5_moe_42b", "seamless_m4t_large_v2"])
def test_f64_prefill_decode_equals_forward_with_f32_islands(arch):
    _, _, cfg, model = shared_model(arch)
    model64 = model.cast(torch.float64)
    cfg64 = model64.cfg
    for name, t in model64.named_parameters():    # the islands stay f32
        want = (torch.float32 if name.rsplit(".", 1)[-1] in
                ("A_log", "D", "dt_bias", "router") else torch.float64)
        assert t.dtype == want, name
    B, S = 2, 32
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_lm_batch(cfg.vocab, S, B).items()}
    batch |= {k: torch.from_numpy(v) for k, v in _extra(cfg, B).items()}
    full, _ = api.forward(model64, cfg64, batch)
    assert full.dtype == torch.float64
    torch.testing.assert_close(full.float(), api.forward(model, cfg, batch)[0],
                               rtol=0, atol=LOGIT_TOL)
    pre = dict(batch, tokens=batch["tokens"][:, :S - 1])
    logits_pre, cache = api.prefill(model64, cfg64, pre, max_seq=S)
    logits_dec, _ = api.decode_step(model64, cfg64, cache,
                                    batch["tokens"][:, -1],
                                    torch.full((B,), S - 1))
    torch.testing.assert_close(logits_pre, full[:, S - 2], rtol=0,
                               atol=ISLAND_TOL)
    torch.testing.assert_close(logits_dec, full[:, S - 1], rtol=0,
                               atol=ISLAND_TOL)


def _greedy_oracle(model, cfg, prompt, new):
    """Step-by-step greedy decoding through the full forward."""
    toks = list(prompt)
    for _ in range(new):
        logits, _ = api.forward(model, cfg, {"tokens": torch.tensor([toks])})
        toks.append(int(torch.argmax(logits[0, -1, :cfg.vocab])))
    return toks[len(prompt):]


@pytest.mark.parametrize("arch", ["mamba2_370m", "jamba_1_5_large_398b"])
def test_recurrent_engine_matches_stepwise_oracle(arch):
    """ssm / hybrid: the first token comes from the unpadded prefill's
    logits and decode starts at plen, so the engine's greedy tokens equal
    the step-by-step greedy forward on prompts of distinct tokens (3
    requests of one and two chunks through 2 slots)."""
    _, _, tc, model = shared_model(arch)
    chunk = tc.ssm.chunk
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(1, tc.vocab, size=n)))
               for n in (chunk, 2 * chunk, chunk)]
    eng = Engine(tc, model, ServeConfig(max_seq=128, slots=2))
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        eng.add_request([1] * (chunk + 1))
    outs = eng.generate(prompts, max_new=6)
    assert outs == [_greedy_oracle(model, tc, p, 6) for p in prompts]
    assert not eng.active.any() and not eng.queue


def test_recurrent_engine_on_a_constant_prompt_equals_reference():
    """On tests/test_decode.py's constant prompt ([2] * chunk, mamba2),
    where the reference engine's replay of the last token meets its
    oracle, the two engines give the same tokens.  (On jamba's reduced
    config the replayed token moves the mamba layers' states enough that
    the reference departs from its oracle even on this prompt.)"""
    jc, params, tc, model = shared_model("mamba2_370m")
    prompt = [2] * tc.ssm.chunk
    outs = Engine(tc, model, ServeConfig(max_seq=256, slots=1)).generate(
        [prompt], max_new=4)
    jouts = JEngine(jc, params, JServeConfig(max_seq=256, slots=1)).generate(
        [prompt], max_new=4)
    assert outs == jouts
    assert outs[0] == _greedy_oracle(model, tc, prompt, 4)


def test_reference_engine_replay_departs_from_its_oracle():
    """The reference engine replays the last prompt token through decode
    for mamba too, feeding it to the conv and ssm states twice; on a prompt
    of distinct tokens its tokens leave the greedy oracle that the port's
    engine meets (ROADMAP.md, queue 3)."""
    jc, params, tc, model = shared_model("mamba2_370m")
    prompt = list(map(int, np.random.default_rng(7).integers(
        1, tc.vocab, size=tc.ssm.chunk)))
    oracle = _greedy_oracle(model, tc, prompt, 6)
    jouts = JEngine(jc, params, JServeConfig(max_seq=128, slots=1)).generate(
        [prompt], max_new=6)
    outs = Engine(tc, model, ServeConfig(max_seq=128, slots=1)).generate(
        [prompt], max_new=6)
    assert outs[0] == oracle and jouts[0] != oracle
    # why: the unpadded prefill's last logits are the forward's, the
    # replayed decode's are not (read: 7.2e-7 and 4.46, largest logit 3.04)
    toks = jnp.asarray([prompt])
    full, _ = japi.forward(params, jc, {"tokens": toks})
    last = np.asarray(full[0, -1])
    lp, cache = japi.prefill(params, jc, {"tokens": toks}, max_seq=128)
    replay, _ = japi.decode_step(params, jc, cache, toks[:, -1],
                                 jnp.asarray([len(prompt) - 1]))
    assert np.abs(np.asarray(lp[0]) - last).max() < 1e-5
    assert np.abs(np.asarray(replay[0]) - last).max() > 0.1


@pytest.mark.parametrize("arch", ["phi3_5_moe_42b", "dbrx_132b"])
def test_moe_engine_matches_reference_and_oracle(arch):
    """The moe family keeps the attention families' replay: the reference
    engine's tokens and the greedy oracle's (4 prompts of mixed length
    through 2 slots)."""
    jc, params, tc, model = shared_model(arch)
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(1, tc.vocab, size=n)))
               for n in (3, 17, 9, 24)]
    sc = {"max_seq": 64, "slots": 2, "min_bucket": 8}
    outs = Engine(tc, model, ServeConfig(**sc)).generate(prompts, max_new=5)
    assert outs == JEngine(jc, params, JServeConfig(**sc)).generate(
        prompts, max_new=5)
    assert outs[0] == _greedy_oracle(model, tc, prompts[0], 5)


def test_engine_refuses_the_encoder_decoder():
    """A token request carries no encoder frames: the audio family is
    refused with the reason, and served through prefill / decode_step."""
    from repro_torch.configs import get_reduced
    with pytest.raises(ValueError, match="src_embeds"):
        Engine(get_reduced("seamless_m4t_large_v2"), None, ServeConfig())
