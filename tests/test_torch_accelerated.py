"""The port's accelerated (momentum) formulation against the reference's.

Both sides get the same numpy problem and the same explicit index stream.
Port against reference in f64 at ``impl="ref"``: rtol 1e-10 / atol 1e-12
on w, alpha and every history series (XLA and ATen sum and factor in
different orders, a few ulps apart).  Port against port: ``beta = 0``
equals the primal ridge solve under ``torch.equal``, at s = 1, at s = 4
and with a ragged tail.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
from repro_torch import core as T
from repro_torch.core.accelerated import MomentumWrapper

from _x64 import x64_mode  # noqa: F401  (autouse fixture)

RTOL, ATOL = 1e-10, 1e-12
LAM = 1e-3
D, N, B = 40, 120, 4
SCHEDULES = [(20, 1), (20, 4), (21, 4)]      # classical, CA, ragged tail


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((D, N))
    y = X.T @ rng.standard_normal(D) + 0.1 * rng.standard_normal(N)
    return X, y


def _idx(iters, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(D, B, replace=False)
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


@pytest.mark.parametrize("iters,s", SCHEDULES)
def test_beta_zero_is_primal_bit_for_bit(problem, iters, s):
    X, y = problem
    idx = _t(_idx(iters))
    acc = T.get_solver("accelerated")(_t(X), _t(y), LAM, B, s, iters,
                                      idx=idx, beta=0.0)
    ridge = T.get_solver("primal")(_t(X), _t(y), LAM, B, s, iters, idx=idx)
    assert torch.equal(acc.w, ridge.w)
    assert torch.equal(acc.alpha, ridge.alpha)
    assert sorted(acc.history) == sorted(ridge.history)
    for key in ridge.history:
        assert torch.equal(acc.history[key], ridge.history[key]), key


@pytest.mark.parametrize("iters,s", SCHEDULES)
def test_momentum_matches_reference(problem, iters, s):
    X, y = problem
    idx = _idx(iters)
    w_ref = np.linalg.solve(X @ X.T / N + LAM * np.eye(D), X @ y / N)
    ref = J.ca_accelerated_bcd(jnp.asarray(X), jnp.asarray(y), LAM, B, s,
                               iters, None, beta=0.9, idx=jnp.asarray(idx),
                               w_ref=jnp.asarray(w_ref), impl="ref")
    got = T.ca_accelerated_bcd(_t(X), _t(y), LAM, B, s, iters, beta=0.9,
                               idx=_t(idx), w_ref=_t(w_ref))
    assert set(got.history) == {"objective", "residual", "sol_err"}
    _assert_same(got, ref)


def test_classical_entry_and_warm_start_match_reference(problem):
    X, y = problem
    idx = _idx(9, seed=2)
    w0 = 0.1 * np.random.default_rng(3).standard_normal(D)
    ref = J.accelerated_bcd(jnp.asarray(X), jnp.asarray(y), LAM, B, 9, None,
                            beta=0.7, idx=jnp.asarray(idx),
                            w0=jnp.asarray(w0), impl="ref")
    got = T.accelerated_bcd(_t(X), _t(y), LAM, B, 9, beta=0.7, idx=_t(idx),
                            w0=_t(w0))
    _assert_same(got, ref)


def test_momentum_lowers_the_objective(problem):
    X, y = problem
    for s in (1, 4):
        res = T.ca_accelerated_bcd(_t(X), _t(y), LAM, B, s, 200,
                                   torch.Generator().manual_seed(4),
                                   beta=0.5)
        f = T.objective(_t(X), res.w, _t(y), LAM)
        assert float(f) < float(T.objective(_t(X), torch.zeros(D,
                                            dtype=torch.float64), _t(y),
                                            LAM)) / 10


@pytest.mark.parametrize("beta", [1.0, -0.1])
def test_bad_beta_fails_fast(beta):
    with pytest.raises(ValueError, match="beta"):
        MomentumWrapper(beta=beta)


def test_registry_entry(problem):
    assert T.get_solver("accelerated", "local") is T.ca_accelerated_bcd
    assert ("accelerated", "local") in T.registered_solvers()
    assert isinstance(T.FORMULATIONS["accelerated"], MomentumWrapper)
    X, y = problem
    idx = _t(_idx(8))
    by_name = T.s_step_solve("accelerated", T.SolverPlan(b=B, s=4), _t(X),
                             _t(y), LAM, 8, idx=idx)
    by_wrapper = T.ca_accelerated_bcd(_t(X), _t(y), LAM, B, 4, 8, idx=idx)
    assert torch.equal(by_name.w, by_wrapper.w)


def test_batched_engine_refuses_it(problem):
    X, y = problem
    batch = T.TenantBatch(ys=_t(np.stack([y, y])), lams=[LAM, LAM])
    with pytest.raises(ValueError, match="tenant_batched"):
        T.s_step_solve_batched("accelerated", T.SolverPlan(b=B, s=2), _t(X),
                               batch, 4, idx=_t(_idx(4)))
