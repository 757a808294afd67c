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


@pytest.mark.parametrize("arch", ["llama3_2_3b", "qwen2_0_5b"])
def test_prefill_and_decode_step_match_reference(arch):
    jc, params, tc, model = shared_model(arch)
    B, S, max_seq = 2, 21, 40
    toks = np.random.default_rng(3).integers(0, tc.vocab, size=(B, S))
    toks = toks.astype(np.int32)
    lj, cj = japi.prefill(params, jc, {"tokens": jnp.asarray(toks)},
                          max_seq=max_seq)
    lt, ct = api.prefill(model, tc, {"tokens": torch.from_numpy(toks)},
                         max_seq=max_seq)
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


@pytest.mark.parametrize("arch", ["llama3_2_3b", "qwen2_0_5b",
                                  "granite_3_2b", "llava_next_34b"])
def test_prefill_decode_equals_forward(arch):
    """Inside the port: prefill of S - 1 tokens and one decode step give
    forward's logits at positions S - 2 and S - 1 (the vlm's prefix: prefill
    only, as the reference's test)."""
    _, _, cfg, model = shared_model(arch)
    B, S = 2, 32
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_lm_batch(cfg.vocab, S, B).items()}
    if cfg.family == "vlm":
        batch["extra_embeds"] = 0.1 * torch.from_numpy(
            np.random.default_rng(1).standard_normal(
                (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
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


@pytest.mark.parametrize("arch", ["mamba2_370m", "jamba_1_5_large_398b",
                                  "seamless_m4t_large_v2", "dbrx_132b"])
def test_engine_refuses_unported_families(arch):
    from repro_torch.configs import get_reduced
    with pytest.raises(NotImplementedError, match="next slice"):
        Engine(get_reduced(arch), None, ServeConfig())
