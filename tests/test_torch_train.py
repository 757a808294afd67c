"""The port's loss and its gradients (``models.api.loss_fn``,
``grad_tree()`` and the remat twin) against the reference's, on the CPU;
the optimizer, the train step, the Trainer, the elastic run and the
launcher are in ``test_torch_optim.py``.

* ``loss_fn`` and ``grad_tree()`` against ``jax.value_and_grad(
  api.loss_fn)`` on the reference's weights (``lm_params_from_reference``),
  f32, one reduced config of each family: the loss at atol 1e-5 (read: at
  most 2.4e-6 on losses of about 6), each gradient leaf at 5e-4 of its norm
  (read: at most 6.6e-5; the same gap holds with both packages in f64,
  since the reference keeps its norms, rope and softmax in f32 whatever
  its inputs), the MoE aux loss at rtol 1e-5.
* The remat modes ``full`` / ``dots`` / ``none``: the same bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import api as japi
from repro.models import init_params as jinit
import repro_torch.configs as tconfigs
from repro_torch.data import synthetic_lm_batch
from repro_torch.interop import lm_params_from_reference
from repro_torch.models import api
from repro_torch.models.module import tree_leaves

LOSS_TOL = 1e-5
GRAD_TOL = 5e-4

# one reduced config of each family
FAMILIES = ["llama3_2_3b", "llava_next_34b", "mamba2_370m", "phi3_5_moe_42b",
            "jamba_1_5_large_398b", "seamless_m4t_large_v2"]


def _f32(get, arch, **kw):
    cfg = get(arch)
    f32 = torch.float32 if get is tconfigs.get_reduced else jnp.float32
    return dataclasses.replace(cfg, dtype=f32, param_dtype=f32, **kw)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree, dtype=np.float64)


def _batch(cfg, B=2, S=32, seed=1, masked=True) -> dict:
    """Tokens of the shared stream, a mask with zeros (``masked``), the
    vlm's patch embeddings, the audio family's 8 encoder frames."""
    rng = np.random.default_rng(seed)
    batch = synthetic_lm_batch(cfg.vocab, S, B, seed=seed)
    if masked:
        batch["mask"] = (rng.random(batch["mask"].shape) < 0.8).astype(
            np.float32)
    else:
        del batch["mask"]
    if cfg.family == "vlm":
        batch["extra_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "audio":
        batch["src_embeds"] = (0.1 * rng.standard_normal(
            (B, 8, cfg.d_model))).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    jc, tc = _f32(jconfigs.get_reduced, arch), _f32(tconfigs.get_reduced,
                                                     arch)
    params = jinit(japi.param_specs(jc), jax.random.key(0))
    batch = _batch(tc, masked=arch != "mamba2_370m")   # mamba2: no mask
    (jtotal, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(p, jc, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
        has_aux=True))(params)
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), tc,
                                     device="cpu").trainable()
    total, m = api.loss_fn(model, tc, _torch(batch))
    total.backward()
    assert m.keys() == jm.keys()
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=0,
                               atol=LOSS_TOL)
    for k in ("loss", "ppl_log"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), rtol=0,
                                   atol=LOSS_TOL)
    if tc.moe:
        np.testing.assert_allclose(float(m["moe_aux_loss"]),
                                   float(jm["moe_aux_loss"]), rtol=1e-5)
    got = dict(_leaves(api.tree_map(lambda t: t.numpy(), model.grad_tree(),
                                    is_leaf=torch.is_tensor)))
    want = dict(_leaves(jax.tree.map(np.asarray, jg)))
    assert got.keys() == want.keys()
    for k in want:
        err = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        assert err < GRAD_TOL, (k, err)
    # the buffers are the parameters' own .grad, in the stacked layout
    assert all(p.grad is not None for p in model.parameters())
    assert got.keys() == dict(_leaves(api.tree_map(
        lambda t: t.numpy(), model.param_tree(), is_leaf=torch.is_tensor)))\
        .keys()


def test_loss_ignores_vocab_padding():
    """Labels never hit padded vocab rows; the loss and its gradient are
    finite (the twin of the reference's test)."""
    cfg = _f32(tconfigs.get_reduced, "granite_3_2b")
    assert cfg.padded_vocab > cfg.vocab
    model = api.init_model(cfg, torch.Generator().manual_seed(0)).trainable()
    batch = _torch(synthetic_lm_batch(cfg.vocab, 32, 2, seed=0))
    assert int(batch["labels"].max()) < cfg.vocab
    total, _ = api.loss_fn(model, cfg, batch)
    total.backward()
    assert torch.isfinite(total)
    assert all(torch.isfinite(g).all() for g in
               tree_leaves(model.grad_tree(), is_leaf=torch.is_tensor))


class _OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten ops run under it."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["llama3_2_3b", "phi3_5_moe_42b",
                                  "seamless_m4t_large_v2"])
def test_remat_modes_give_the_same_bits(arch):
    out, ops = {}, {}
    for remat in ("none", "full", "dots"):
        cfg = _f32(tconfigs.get_reduced, arch, remat=remat)
        model = api.init_model(cfg, torch.Generator().manual_seed(0))
        model.trainable()
        total, _ = api.loss_fn(model, cfg, _torch(_batch(cfg)))
        with _OpCount() as count:
            total.backward()
        out[remat] = (total.detach(), [g.clone() for g in tree_leaves(
            model.grad_tree(), is_leaf=torch.is_tensor)])
        ops[remat] = (count.n.get(torch.ops.aten.mm.default, 0),
                      count.n.get(torch.ops.aten.silu.default, 0))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b), remat
    # backward recomputes the forward's products under "full" only, its
    # other operations (silu) under "full" and "dots"
    (mm_n, silu_n), (mm_f, silu_f), (mm_d, silu_d) = (
        ops["none"], ops["full"], ops["dots"])
    assert mm_f > mm_d == mm_n and silu_f >= silu_d > silu_n == 0, ops
