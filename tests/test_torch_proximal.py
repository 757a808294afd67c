"""The port's proximal (elastic-net) formulation against the reference's.

Both sides get the same numpy problem and index stream.  Port against
reference in f64: rtol 1e-10 / atol 1e-12 on w, alpha and every history
series (XLA and ATen sum and factor in different orders, a few ulps apart).
Port against port: ``lam1 = 0`` equals the ridge solve bit for bit, and
CA(s) equals classical within 1e-11 relative (f64; the sums regroup).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
from repro.core import proximal as jprox
from repro.core import subproblem as jsub
from repro_torch import core as T

from _x64 import x64_mode  # noqa: F401  (autouse fixture)

RTOL, ATOL = 1e-10, 1e-12
LAM = 1e-3
D, N, B = 30, 80, 4


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((D, N))
    y = X.T @ (rng.standard_normal(D) * (rng.random(D) < 0.3)) \
        + 0.1 * rng.standard_normal(N)
    lam1 = 0.1 * float(np.max(np.abs(X @ y)) / N)
    return X, y, lam1


def _idx(iters, seed=1, dim=D):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(dim, B, replace=False)
                     for _ in range(iters)]).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_same(port, ref):
    np.testing.assert_allclose(port.w.numpy(), np.asarray(ref.w), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(port.alpha.numpy(), np.asarray(ref.alpha),
                               rtol=RTOL, atol=ATOL)
    assert sorted(port.history) == sorted(ref.history)
    for key, series in ref.history.items():
        np.testing.assert_allclose(port.history[key].numpy(),
                                   np.asarray(series), rtol=RTOL, atol=ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("s,iters", [(1, 13), (3, 13), (4, 12), (8, 5)])
def test_ca_proximal_bcd_matches_reference(problem, s, iters):
    X, y, lam1 = problem
    idx = _idx(iters)
    w_ref = np.linalg.solve(X @ X.T / N + LAM * np.eye(D), X @ y / N)
    ref = J.ca_proximal_bcd(jnp.asarray(X), jnp.asarray(y), LAM, B, s, iters,
                            None, lam1=lam1, idx=jnp.asarray(idx),
                            w_ref=jnp.asarray(w_ref), impl="ref")
    got = T.ca_proximal_bcd(_t(X), _t(y), LAM, B, s, iters, lam1=lam1,
                            idx=_t(idx), w_ref=_t(w_ref))
    assert set(got.history) == {"objective", "nnz", "residual", "sol_err"}
    _assert_same(got, ref)


def test_proximal_bcd_and_warm_start_match_reference(problem):
    X, y, lam1 = problem
    idx = _idx(9, seed=2)
    w0 = 0.1 * np.random.default_rng(3).standard_normal(D)
    ref = J.proximal_bcd(jnp.asarray(X), jnp.asarray(y), LAM, B, 9, None,
                         lam1=lam1, idx=jnp.asarray(idx), w0=jnp.asarray(w0),
                         impl="ref")
    got = T.proximal_bcd(_t(X), _t(y), LAM, B, 9, lam1=lam1, idx=_t(idx),
                         w0=_t(w0))
    _assert_same(got, ref)


def test_hand_rolled_reference_matches_reference(problem):
    X, y, lam1 = problem
    idx = _idx(15, seed=4)
    w_j, a_j = jprox.proximal_bcd_reference(jnp.asarray(X), jnp.asarray(y),
                                            LAM, lam1, B, 15,
                                            jnp.asarray(idx))
    w_t, a_t = T.proximal_bcd_reference(_t(X), _t(y), LAM, lam1, B, 15,
                                        _t(idx))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("iters,s", [(20, 4), (7, 3), (3, 8)])
def test_ca_equals_classical_and_the_hand_rolled_oracle(problem, iters, s):
    X, y, lam1 = problem
    idx = _t(_idx(iters, seed=5))
    solve = T.get_solver("proximal", "local")
    cl = solve(_t(X), _t(y), LAM, B, 1, iters, idx=idx, lam1=lam1)
    ca = solve(_t(X), _t(y), LAM, B, s, iters, idx=idx, lam1=lam1)
    torch.testing.assert_close(ca.w, cl.w, rtol=1e-11, atol=1e-13)
    torch.testing.assert_close(ca.alpha, cl.alpha, rtol=1e-11, atol=1e-13)
    w_or, _ = T.proximal_bcd_reference(_t(X), _t(y), LAM, lam1, B, iters,
                                       idx)
    torch.testing.assert_close(ca.w, w_or, rtol=1e-11, atol=1e-13)


def test_duplicate_indices_across_blocks(problem):
    X, y, lam1 = problem
    idx = torch.tensor([[0, 1, 2, 3], [2, 3, 4, 5], [0, 5, 6, 7]],
                       dtype=torch.int32)
    cl = T.ca_proximal_bcd(_t(X), _t(y), LAM, B, 1, 3, lam1=lam1, idx=idx)
    ca = T.ca_proximal_bcd(_t(X), _t(y), LAM, B, 3, 3, lam1=lam1, idx=idx)
    torch.testing.assert_close(ca.w, cl.w, rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lam1_zero_is_ridge_bit_for_bit(problem, s, dtype):
    X, y, _ = problem
    idx = _t(_idx(20, seed=6))
    Xt, yt = _t(X).to(dtype), _t(y).to(dtype)
    prox = T.get_solver("proximal", "local")(Xt, yt, LAM, B, s, 20, idx=idx,
                                             lam1=0.0)
    ridge = T.get_solver("primal", "local")(Xt, yt, LAM, B, s, 20, idx=idx)
    assert torch.equal(prox.w, ridge.w) and torch.equal(prox.alpha,
                                                        ridge.alpha)
    by_name = T.s_step_solve("proximal", T.SolverPlan(b=B, s=2), Xt, yt, LAM,
                             20, idx=idx)
    ridge2 = T.s_step_solve("primal", T.SolverPlan(b=B, s=2), Xt, yt, LAM, 20,
                            idx=idx)
    assert torch.equal(by_name.w, ridge2.w)


def test_soft_threshold_sparsifies_and_objective(problem):
    X, y, _ = problem
    lam1 = 0.3 * float(np.max(np.abs(X @ y)) / N)
    res = T.proximal_bcd(_t(X), _t(y), LAM, B, 300,
                         torch.Generator().manual_seed(6), lam1=lam1)
    w = res.w.numpy()
    assert np.sum(w != 0) < D               # exact zeros, not small values
    assert int(res.history["nnz"][-1]) == np.sum(w != 0)
    assert float(res.history["objective"][-1]) < float(
        res.history["objective"][0])
    want = J.elastic_net_objective(jnp.asarray(X), jnp.asarray(w),
                                   jnp.asarray(y), LAM, lam1)
    got = T.elastic_net_objective(_t(X), res.w, _t(y), LAM, lam1)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    np.testing.assert_allclose(float(got), float(res.history["objective"][-1]),
                               rtol=1e-10)


def test_soft_threshold_operator_matches_reference():
    u = np.asarray([-2.0, -0.5, 0.0, 0.5, 2.0, -1.75, 1e-300])
    tau = np.asarray([1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0])
    got = T.soft_threshold(_t(u), _t(tau)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jsub.soft_threshold(jnp.asarray(u), jnp.asarray(tau))))
    v = _t(np.asarray([-1.75, 3.0, 0.0, 1e-300]))
    assert torch.equal(T.soft_threshold(v, torch.zeros(4, dtype=v.dtype)), v)


@pytest.mark.parametrize("s,b", [(1, 4), (3, 4), (4, 2)])
def test_prox_sweep_matches_reference(s, b):
    sb = s * b
    rng = np.random.default_rng(sb)
    M = rng.standard_normal((sb, sb))
    A = M @ M.T + sb * np.eye(sb)
    base, w0 = rng.standard_normal(sb), rng.standard_normal(sb)
    tau = 0.3 * rng.random(sb)
    flat = rng.integers(0, sb // 2 + 1, sb).astype(np.int32)  # duplicates
    O = (flat[:, None] == flat[None, :]).astype(np.float64)
    want = jsub.block_forward_substitution_prox(
        jnp.asarray(A), jnp.asarray(base), s, b, w0=jnp.asarray(w0),
        tau=jnp.asarray(tau), overlap=jnp.asarray(O))
    got = T.block_forward_substitution_prox(_t(A), _t(base), s, b, w0=_t(w0),
                                            tau=_t(tau), overlap=_t(O))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    zero = T.block_forward_substitution_prox(
        _t(A), _t(base), s, b, w0=_t(w0), tau=torch.zeros(sb,
                                                          dtype=torch.float64),
        overlap=torch.eye(sb, dtype=torch.float64))
    torch.testing.assert_close(zero, T.block_forward_substitution(
        _t(A), _t(base), s, b), rtol=1e-12, atol=1e-14)


def test_negative_lam1_fails_fast(problem):
    X, y, _ = problem
    with pytest.raises(ValueError, match="lam1"):
        T.ProximalElasticNet(lam1=-0.1)
    with pytest.raises(ValueError, match="lam1"):
        T.proximal_bcd(_t(X), _t(y), LAM, B, 4, lam1=-1e-3,
                       idx=_t(_idx(4)))


def test_registry_and_formulation_name():
    assert ("proximal", "local") in T.registered_solvers()
    assert T.get_solver("proximal") is T.ca_proximal_bcd
    assert T.FORMULATIONS["proximal"] == T.ProximalElasticNet()
    assert T.ProximalElasticNet.tenant_batched
