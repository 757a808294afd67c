"""The LM probe (``repro_torch.launch.lm_probe``) against the reference's
(``examples/lm_probe.py``), on the CPU.

* Features: the port's ``extract_features`` against the reference's
  expression of it (its decoder stack, final norm, (d_model, tokens) in
  f64), on the reference's weights in f32: atol 1e-3 on features of order
  1, the f32 forward's difference between the packages (6e-5 to 1.3e-3 on
  logits, ``test_torch_models.py``), read 2.0e-4 here.
* The probe's solves in f64 on one shared design matrix, labels and index
  stream: the port's ``bdcd`` / ``ca_bdcd`` against the reference's at
  ``impl="ref"``, rtol 1e-10 (both sum the same f64 products in their own
  orders), and CA-BDCD equal to BDCD within the probe's own 1e-8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bdcd as j_bdcd
from repro.core import ca_bdcd as j_ca_bdcd
from repro.core import ridge_exact as j_ridge
from repro.data import synthetic_lm_batch as j_batch
from repro.models import layers as JL
from repro.models.api import _decoder_stack as j_stack
from repro_torch.launch import lm_probe

from _x64 import x64_mode  # noqa: F401  (autouse fixture)
from test_torch_models import shared_model

FEATURE_TOL = 1e-3


def _reference_features(cfg, params, batch):
    """examples/lm_probe.py's extract_features."""
    x = JL.embed(params, jnp.asarray(batch["tokens"])).astype(cfg.dtype)
    positions = jnp.arange(x.shape[1])[None, :]
    h, _ = j_stack(params, cfg, x, positions)
    h = JL.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return np.asarray(h.reshape(-1, h.shape[-1]).T.astype(jnp.float64))


@pytest.fixture(scope="module")
def probe_inputs():
    jc, params, tc, model = shared_model("llama3_2_3b")
    batch = j_batch(tc.vocab, seq_len=128, batch=8, seed=3)
    return jc, params, tc, model, batch


def test_features_match_reference(probe_inputs):
    jc, params, tc, model, batch = probe_inputs
    got = lm_probe.extract_features(tc, model, batch)
    want = _reference_features(jc, params, batch)
    assert got.dtype == torch.float64 and got.is_contiguous()
    assert got.shape == want.shape == (tc.d_model, 8 * 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FEATURE_TOL)


@pytest.mark.parametrize("s", [10, 7])
def test_probe_solves_match_reference_on_shared_idx(probe_inputs, s):
    jc, params, tc, model, batch = probe_inputs
    X = lm_probe.extract_features(tc, model, batch)
    y = 2.0 * (batch["labels"].reshape(-1) > tc.vocab // 2) - 1.0
    d, n = X.shape
    lam = 1e-4 * float(torch.linalg.norm(X) ** 2 / n)
    iters, b = 200, 32
    idx = np.stack([np.random.default_rng(k).choice(n, b, replace=False)
                    for k in range(iters)]).astype(np.int32)
    Xn = X.numpy()
    w_opt = j_ridge(jnp.asarray(Xn), jnp.asarray(y), lam)
    jcl = j_bdcd(jnp.asarray(Xn), jnp.asarray(y), lam, b, iters, None,
                 idx=jnp.asarray(idx), w_ref=w_opt, impl="ref")
    jca = j_ca_bdcd(jnp.asarray(Xn), jnp.asarray(y), lam, b, s, iters, None,
                    idx=jnp.asarray(idx), w_ref=w_opt, impl="ref")
    yt, it = torch.from_numpy(y), torch.from_numpy(idx)
    w_t = lm_probe.ridge_exact(X, yt, lam)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_opt), rtol=1e-10,
                               atol=1e-13)
    tcl = lm_probe.bdcd(X, yt, lam, b, iters, idx=it, w_ref=w_t)
    tca = lm_probe.ca_bdcd(X, yt, lam, b, s, iters, idx=it, w_ref=w_t)
    for t, j in ((tcl, jcl), (tca, jca)):
        np.testing.assert_allclose(t.w.numpy(), np.asarray(j.w), rtol=1e-10,
                                   atol=1e-13)
        np.testing.assert_allclose(t.history["sol_err"].numpy(),
                                   np.asarray(j.history["sol_err"]),
                                   rtol=1e-8)
    assert float((tca.w - tcl.w).abs().max()) < 1e-8


def test_probe_runs_end_to_end_on_the_cpu():
    """The launcher's own path (its weights, batch and index stream) at the
    reduced width: CA-BDCD equal to BDCD, 200 against 20 reductions."""
    out = lm_probe.main(0, device="cpu")
    assert out["dev"] < 1e-8
    assert (out["d"], out["n"]) == (64, 1024)
    assert 0.0 <= out["acc"] <= 1.0 and np.isfinite(out["err"])
    assert out["iters"] // out["s"] == 20
