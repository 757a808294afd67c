"""The port's tenant-batched engine against the reference's, and against
itself.

Port against reference: the same numpy problem, per-tenant weights and index
stream go to ``repro.core.s_step_solve_batched`` with ``impl="ref"`` in f64
and to the port's, which resolves to its plain versions on CPU tensors.
Tolerance rtol 1e-10 / atol 1e-12: XLA and ATen sum in different orders, so
the two agree to a few ulps, far inside it.

Port against port, under ``torch.equal`` (no tolerance): a batched solve
equals its T single solves in f32 and f64, a masked tenant stays frozen while
its neighbours still match, tol retirement returns the first outer step's
iterates, and a chunked resume equals one whole solve.  Proximal tenants use
``lam1 > 0`` in the comparisons with the reference, whose batched ``lam1``
is traced and so never takes the ridge branch at ``lam1 = 0``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
from repro_torch import core as T
from repro_torch.interop import (batch_from_numpy, batched_result_to_numpy,
                                 plan_from_reference)

from _x64 import x64_mode  # noqa: F401  (autouse fixture)

RTOL, ATOL = 1e-10, 1e-12
D, N, TEN, B, S = 24, 40, 3, 4, 3
LAMS = (0.1, 0.5, 1.0)
LAM1S = (0.02, 0.01, 0.05)
FORMS = ("primal", "dual", "proximal")


def _problem(npdt=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((D, N)).astype(npdt),
            rng.standard_normal((TEN, N)).astype(npdt))


def _idx(form, iters, seed=1):
    dim = N if form == "dual" else D
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(dim, B, replace=False)
                     for _ in range(iters)]).astype(np.int32)


def _coeffs(form):
    return {"lam1": np.asarray(LAM1S)} if form == "proximal" else {}


def _port_batch(form, X, ys, tol=None, lams=LAMS):
    dtype = torch.from_numpy(X).dtype
    return batch_from_numpy(ys, lams, _coeffs(form), tol=tol, device="cpu",
                            dtype=dtype)


def _ref_batch(form, ys, tol=None):
    return J.TenantBatch(ys=jnp.asarray(ys), lams=jnp.asarray(LAMS),
                         coeffs={k: jnp.asarray(v)
                                 for k, v in _coeffs(form).items()}, tol=tol)


def _single(form, t, plan, X, ys, iters, idx, lams=LAMS):
    f = T.ProximalElasticNet(lam1=LAM1S[t]) if form == "proximal" else form
    return T.s_step_solve(f, plan, X, ys[t], lams[t], iters, idx=idx)


def _bits_equal(a, b):
    """Equal bit for bit (tells -0.0 from 0.0, unlike torch.equal)."""
    return torch.equal(a.view(torch.int64 if a.dtype == torch.float64
                              else torch.int32),
                       b.view(torch.int64 if b.dtype == torch.float64
                              else torch.int32))


# --------------------------------------------------------------------------
# Port against reference, f64
# --------------------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("iters", [6, 7])        # 2 full steps; ragged tail
def test_batched_matches_reference(form, iters):
    X, ys = _problem()
    idx = _idx(form, iters)
    want = J.s_step_solve_batched(form, J.SolverPlan(b=B, s=S, impl="ref"),
                                  jnp.asarray(X), _ref_batch(form, ys), iters,
                                  idx=jnp.asarray(idx))
    plan = plan_from_reference(b=B, s=S, impl="ref", tenants=TEN)
    got = batched_result_to_numpy(T.s_step_solve_batched(
        form, plan, torch.from_numpy(X), _port_batch(form, X, ys), iters,
        idx=torch.from_numpy(idx)))
    np.testing.assert_allclose(got.ws, np.asarray(want.ws), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.alphas, np.asarray(want.alphas),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.active, np.asarray(want.active))


@pytest.mark.parametrize("form", ["primal", "dual"])
def test_batched_warm_starts_match_reference(form):
    X, ys = _problem()
    dim = D if form == "primal" else N
    x0s = 0.1 * np.random.default_rng(4).standard_normal((TEN, dim))
    idx = _idx(form, 5, seed=2)
    want = J.s_step_solve_batched(
        form, J.SolverPlan(b=B, s=S, impl="ref"), jnp.asarray(X),
        J.TenantBatch(ys=jnp.asarray(ys), lams=jnp.asarray(LAMS),
                      x0s=jnp.asarray(x0s)), 5, idx=jnp.asarray(idx))
    got = T.s_step_solve_batched(
        form, T.SolverPlan(b=B, s=S), torch.from_numpy(X),
        batch_from_numpy(ys, LAMS, x0s=x0s, device="cpu",
                         dtype=torch.float64), 5, idx=torch.from_numpy(idx))
    np.testing.assert_allclose(got.ws.numpy(), np.asarray(want.ws),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.alphas.numpy(), np.asarray(want.alphas),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("form", ["primal", "dual"])
def test_tol_retirement_matches_reference(form):
    """Per-step retirement on the residual: the same tenants retire at the
    same steps on both sides (the tolerance sits between their residuals)."""
    X, ys = _problem()
    idx = _idx(form, 12, seed=3)
    res = T.s_step_solve_batched(form, T.SolverPlan(b=B, s=S),
                                 torch.from_numpy(X),
                                 _port_batch(form, X, ys), S,
                                 idx=torch.from_numpy(idx[:S]))
    r1 = T.batched_residuals(form, torch.from_numpy(X),
                             _port_batch(form, X, ys), (res.ws, res.alphas))
    tol = float(r1.median())                 # one tenant retires at step 1
    want = J.s_step_solve_batched(
        form, J.SolverPlan(b=B, s=S, impl="ref"), jnp.asarray(X),
        _ref_batch(form, ys, tol=tol), 12, idx=jnp.asarray(idx))
    got = T.s_step_solve_batched(form, T.SolverPlan(b=B, s=S),
                                 torch.from_numpy(X),
                                 _port_batch(form, X, ys, tol=tol), 12,
                                 idx=torch.from_numpy(idx))
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    assert not bool(got.active.all())
    np.testing.assert_allclose(got.ws.numpy(), np.asarray(want.ws),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("form", FORMS)
def test_batched_residuals_match_reference(form):
    X, ys = _problem()
    rng = np.random.default_rng(6)
    ws, alphas = rng.standard_normal((TEN, D)), rng.standard_normal((TEN, N))
    want = J.batched_residuals(form, jnp.asarray(X), _ref_batch(form, ys),
                               (jnp.asarray(ws), jnp.asarray(alphas)))
    got = T.batched_residuals(form, torch.from_numpy(X),
                              _port_batch(form, X, ys),
                              (torch.from_numpy(ws), torch.from_numpy(alphas)))
    assert got.shape == (TEN,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# --------------------------------------------------------------------------
# Port against port, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("iters", [6, 7])
@pytest.mark.parametrize("npdt", [np.float32, np.float64])
def test_batched_equals_singles_bitwise(form, iters, npdt):
    X, ys = _problem(npdt)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(ys)
    idx = torch.from_numpy(_idx(form, iters, seed=7))
    plan = T.SolverPlan(b=B, s=S)
    res = T.s_step_solve_batched(form, plan, Xt, _port_batch(form, X, ys),
                                 iters, idx=idx)
    assert bool(res.active.all())
    for t in range(TEN):
        single = _single(form, t, plan, Xt, yt, iters, idx)
        assert _bits_equal(res.ws[t], single.w)
        assert _bits_equal(res.alphas[t], single.alpha)


@pytest.mark.parametrize("form", ["primal", "dual"])
def test_masked_tenant_frozen_neighbours_match(form):
    X, ys = _problem(np.float32)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(ys)
    plan = T.SolverPlan(b=B, s=S)
    # a warm carry, so that "frozen" is not just "still zero"
    warm = T.s_step_solve_batched(form, plan, Xt, _port_batch(form, X, ys),
                                  S, idx=torch.from_numpy(_idx(form, S, 8)))
    idx = torch.from_numpy(_idx(form, 6, seed=9))
    res = T.s_step_solve_batched(
        form, plan, Xt, _port_batch(form, X, ys), 6, idx=idx,
        carry0=(warm.ws, warm.alphas), active0=[True, False, True])
    assert res.active.tolist() == [True, False, True]
    assert _bits_equal(res.ws[1], warm.ws[1])
    assert _bits_equal(res.alphas[1], warm.alphas[1])
    whole = T.s_step_solve_batched(
        form, plan, Xt, _port_batch(form, X, ys), S + 6,
        idx=torch.cat([torch.from_numpy(_idx(form, S, 8)), idx]))
    for t in (0, 2):
        assert _bits_equal(res.ws[t], whole.ws[t])
        assert _bits_equal(res.alphas[t], whole.alphas[t])


def test_tol_retirement_returns_first_step_iterates():
    """A tolerance every tenant meets after the first outer step: a longer
    solve returns exactly the one-step iterates."""
    X, ys = _problem(np.float32)
    Xt = torch.from_numpy(X)
    idx = torch.from_numpy(_idx("primal", 9, seed=5))
    plan = T.SolverPlan(b=B, s=S)
    long = T.s_step_solve_batched("primal", plan, Xt,
                                  _port_batch("primal", X, ys, tol=10.0), 9,
                                  idx=idx)
    short = T.s_step_solve_batched("primal", plan, Xt,
                                   _port_batch("primal", X, ys), S,
                                   idx=idx[:S])
    assert not bool(long.active.any())
    assert _bits_equal(long.ws, short.ws)
    assert _bits_equal(long.alphas, short.alphas)


@pytest.mark.parametrize("form", FORMS)
def test_chunked_resume_equals_whole_solve(form):
    X, ys = _problem(np.float32)
    Xt = torch.from_numpy(X)
    idx = torch.from_numpy(_idx(form, 13, seed=11))
    plan = T.SolverPlan(b=B, s=S)
    batch = _port_batch(form, X, ys)
    whole = T.s_step_solve_batched(form, plan, Xt, batch, 13, idx=idx)
    half = T.s_step_solve_batched(form, plan, Xt, batch, 6, idx=idx[:6])
    resumed = T.s_step_solve_batched(form, plan, Xt, batch, 7, idx=idx[6:],
                                     carry0=(half.ws, half.alphas),
                                     active0=half.active)
    assert _bits_equal(resumed.ws, whole.ws)
    assert _bits_equal(resumed.alphas, whole.alphas)


def test_proximal_lam1_zero_tenant_is_ridge():
    """A batched lam1 = 0 tenant takes the ridge sweep, as its single solve
    does: it equals the primal tenant bit for bit."""
    X, ys = _problem(np.float32)
    Xt = torch.from_numpy(X)
    idx = torch.from_numpy(_idx("primal", 7, seed=12))
    plan = T.SolverPlan(b=B, s=S)
    prox = T.s_step_solve_batched(
        "proximal", plan, Xt,
        batch_from_numpy(ys, LAMS, {"lam1": [0.0, 0.03, 0.0]}, device="cpu",
                         dtype=torch.float32), 7, idx=idx)
    ridge = T.s_step_solve_batched("primal", plan, Xt,
                                   _port_batch("primal", X, ys), 7, idx=idx)
    for t in (0, 2):
        assert _bits_equal(prox.ws[t], ridge.ws[t])
    assert not torch.equal(prox.ws[1], ridge.ws[1])


def test_generator_draws_the_index_stream():
    X, ys = _problem()
    Xt = torch.from_numpy(X)
    plan = T.SolverPlan(b=B, s=S)
    res = [T.s_step_solve_batched("primal", plan, Xt,
                                  _port_batch("primal", X, ys), 5,
                                  torch.Generator().manual_seed(3))
           for _ in range(2)]
    assert torch.equal(res[0].ws, res[1].ws)
    with pytest.raises(ValueError, match="Generator"):
        T.s_step_solve_batched("primal", plan, Xt,
                               _port_batch("primal", X, ys), 5)


# --------------------------------------------------------------------------
# Refusals
# --------------------------------------------------------------------------

def test_tenant_batch_checks_its_shapes():
    ys = torch.zeros((3, 5))
    with pytest.raises(ValueError, match="tenants, n"):
        T.TenantBatch(ys=torch.zeros(5), lams=[1.0])
    with pytest.raises(ValueError, match="lams has 2 entries"):
        T.TenantBatch(ys=ys, lams=[1.0, 2.0])
    with pytest.raises(ValueError, match="lam1"):
        T.TenantBatch(ys=ys, lams=[1.0] * 3, coeffs={"lam1": [0.1]})
    with pytest.raises(ValueError, match="x0s"):
        T.TenantBatch(ys=ys, lams=[1.0] * 3, x0s=torch.zeros((2, 4)))
    with pytest.raises(ValueError, match="tol"):
        T.TenantBatch(ys=ys, lams=[1.0] * 3, tol=0.0)
    batch = T.TenantBatch(ys=ys, lams=torch.tensor([0.5, 1.0, 2.0]))
    assert batch.lams == (0.5, 1.0, 2.0) and batch.tenants == 3


def test_batched_solve_refusals():
    X, ys = _problem()
    Xt = torch.from_numpy(X)
    batch = _port_batch("primal", X, ys)
    idx = torch.from_numpy(_idx("primal", 3))

    class NotBatched:
        name = "plain"

    with pytest.raises(ValueError, match="tenant-batched"):
        T.s_step_solve_batched(NotBatched(), T.SolverPlan(b=B), Xt, batch, 3,
                               idx=idx)
    with pytest.raises(ValueError, match="track_cond"):
        T.s_step_solve_batched("primal", T.SolverPlan(b=B, track_cond=True),
                               Xt, batch, 3, idx=idx)
    with pytest.raises(ValueError, match="tenants=2"):
        T.s_step_solve_batched("primal", T.SolverPlan(b=B, tenants=2), Xt,
                               batch, 3, idx=idx)
    with pytest.raises(ValueError, match="idx shape"):
        T.s_step_solve_batched("primal", T.SolverPlan(b=B), Xt, batch, 4,
                               idx=idx)
    with pytest.raises(ValueError, match="carry0"):
        T.s_step_solve_batched("primal", T.SolverPlan(b=B), Xt, batch, 3,
                               idx=idx, carry0=(torch.zeros((3, D)),
                                                torch.zeros((2, N))))
    with pytest.raises(ValueError, match="active0"):
        T.s_step_solve_batched("primal", T.SolverPlan(b=B), Xt, batch, 3,
                               idx=idx, active0=[True])
    for bad in (0, -1, 1.5):
        with pytest.raises(ValueError, match="tenants"):
            T.SolverPlan(b=B, tenants=bad)


def test_batch_interop_round_trip():
    X, ys = _problem()
    batch = batch_from_numpy(ys, np.asarray(LAMS), _coeffs("proximal"),
                             x0s=np.zeros((TEN, D)), tol=1e-3, device="cpu",
                             dtype=torch.float32)
    assert batch.ys.dtype == torch.float32 and batch.lams == LAMS
    assert batch.coeffs == {"lam1": LAM1S} and batch.tol == 1e-3
    assert plan_from_reference(b=2, tenants=8).tenants == 8
