"""The port's s-step engine against the reference engine, on the CPU.

Both packages get the same numpy problem and the same index stream (through
``repro_torch.interop``).  The reference runs ``impl="ref"`` in f64; the port
resolves to its plain versions on CPU tensors.  Tolerance: rtol 1e-10 /
atol 1e-12 on w, alpha and every history series -- the solves agree to a few
ulps (XLA and ATen sum in different orders), far inside it.

Covered: both formulations at s in {1, 3, 8} with a ragged tail (iters = 13),
warm starts, the history series (objective, residual, sol_err, gram_cond),
the classical wrappers, idx validation, the registry, CA(s) == classical
port against port, the interop round trip, the direct solve and the data
generator.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import SolverPlan as JPlan
from repro_torch import core as T
from repro_torch.data import (PAPER_DATASETS, PAPER_DATASETS_FULL,
                              SyntheticSpec, lam_for, make_regression)
from repro_torch.interop import (plan_from_reference, problem_from_numpy,
                                 result_to_numpy)
from repro_torch.launch import quickstart

from _x64 import x64_mode  # noqa: F401  (autouse fixture)

RTOL, ATOL = 1e-10, 1e-12
LAM = 1e-2
D, N, B, ITERS = 24, 40, 4, 13


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((D, N))
    y = rng.standard_normal(N)
    return X, y


def _idx(dim, iters=ITERS, b=B, seed=1):
    """Distinct indices within each row; repeats across rows are legal and
    frequent at these sizes (exercised by every solve below)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(dim, b, replace=False)
                     for _ in range(iters)]).astype(np.int32)


def _assert_same(port, ref):
    """Port result (numpy, via result_to_numpy) against a reference result."""
    np.testing.assert_allclose(port.w, np.asarray(ref.w), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port.alpha, np.asarray(ref.alpha), rtol=RTOL,
                               atol=ATOL)
    assert sorted(port.history) == sorted(ref.history)
    for key, series in ref.history.items():
        np.testing.assert_allclose(port.history[key], np.asarray(series),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


FORMS = {"primal": (J.ca_bcd, T.ca_bcd, 0), "dual": (J.ca_bdcd, T.ca_bdcd, 1)}


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("s", [1, 3, 8])
def test_ca_solve_matches_reference(problem, form, s):
    X, y = problem
    jsolve, tsolve, axis = FORMS[form]
    idx = _idx(X.shape[axis])
    w_ref = np.linalg.solve(X @ X.T / N + LAM * np.eye(D), X @ y / N)
    res_j = jsolve(jnp.asarray(X), jnp.asarray(y), LAM, B, s, ITERS, None,
                   idx=jnp.asarray(idx), w_ref=jnp.asarray(w_ref),
                   track_cond=True, impl="ref")
    Xt, yt, it, _ = problem_from_numpy(X, y, idx, device="cpu",
                                       dtype=torch.float64)
    res_t = tsolve(Xt, yt, LAM, B, s, ITERS, idx=it,
                   w_ref=torch.from_numpy(w_ref), track_cond=True)
    port = result_to_numpy(res_t)
    assert set(port.history) == {"objective", "residual", "sol_err",
                                 "gram_cond"}
    assert all(v.shape == (ITERS,) for v in port.history.values())
    _assert_same(port, res_j)


@pytest.mark.parametrize("form", FORMS)
def test_warm_start_matches_reference(problem, form):
    X, y = problem
    jsolve, tsolve, axis = FORMS[form]
    rng = np.random.default_rng(5)
    x0 = 0.1 * rng.standard_normal(X.shape[axis])
    idx = _idx(X.shape[axis], seed=2)
    kw = "w0" if form == "primal" else "alpha0"
    res_j = jsolve(jnp.asarray(X), jnp.asarray(y), LAM, B, 3, ITERS, None,
                   idx=jnp.asarray(idx), impl="ref", **{kw: jnp.asarray(x0)})
    Xt, yt, it, x0t = problem_from_numpy(X, y, idx, x0, device="cpu",
                                         dtype=torch.float64)
    res_t = tsolve(Xt, yt, LAM, B, 3, ITERS, idx=it, **{kw: x0t})
    _assert_same(result_to_numpy(res_t), res_j)


@pytest.mark.parametrize("form", FORMS)
def test_classical_wrappers_match_reference(problem, form):
    X, y = problem
    axis = FORMS[form][2]
    jsolve, tsolve = (J.bcd, T.bcd) if form == "primal" else (J.bdcd, T.bdcd)
    idx = _idx(X.shape[axis], iters=9, seed=3)
    res_j = jsolve(jnp.asarray(X), jnp.asarray(y), LAM, B, 9, None,
                   idx=jnp.asarray(idx), impl="ref")
    Xt, yt, it, _ = problem_from_numpy(X, y, idx, device="cpu",
                                       dtype=torch.float64)
    _assert_same(result_to_numpy(tsolve(Xt, yt, LAM, B, 9, idx=it)), res_j)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("s", [2, 3, 5, 13, 16])
def test_ca_equals_classical_port_against_port(problem, form, s):
    """The paper's claim on the port alone: CA(s) reproduces classical BCD /
    BDCD for the same index stream, including ragged tails (13 % s != 0 for
    s in {2, 3, 5}) and s > iters."""
    X, y = problem
    _, tsolve, axis = FORMS[form]
    Xt, yt, it, _ = problem_from_numpy(X, y, _idx(X.shape[axis], seed=4),
                                       device="cpu", dtype=torch.float64)
    base = tsolve(Xt, yt, LAM, B, 1, ITERS, idx=it)
    ca = tsolve(Xt, yt, LAM, B, s, ITERS, idx=it)
    torch.testing.assert_close(ca.w, base.w, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(ca.alpha, base.alpha, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(ca.history["objective"],
                               base.history["objective"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("form", FORMS)
def test_idx_shape_mismatch_raises(problem, form):
    X, y = problem
    _, tsolve, axis = FORMS[form]
    Xt, yt, it, _ = problem_from_numpy(X, y, _idx(X.shape[axis]),
                                       device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="does not match"):
        tsolve(Xt, yt, LAM, B, 3, ITERS + 1, idx=it)
    with pytest.raises(ValueError, match="does not match"):
        tsolve(Xt, yt, LAM, B + 1, 3, ITERS, idx=it)


def test_solve_without_idx_samples_from_the_generator(problem):
    X, y = problem
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    a = T.ca_bcd(Xt, yt, LAM, B, 3, ITERS, torch.Generator().manual_seed(9))
    idx = T.sample_blocks(torch.Generator().manual_seed(9), D, B, ITERS)
    b = T.ca_bcd(Xt, yt, LAM, B, 3, ITERS, idx=idx)
    assert torch.equal(a.w, b.w)
    with pytest.raises(ValueError, match="Generator"):
        T.ca_bcd(Xt, yt, LAM, B, 3, ITERS)


def test_registry_and_string_formulations(problem):
    assert T.get_solver("primal") is T.ca_bcd
    assert T.get_solver("dual", "local") is T.ca_bdcd
    assert set(T.registered_solvers()) >= {("primal", "local"),
                                           ("dual", "local"),
                                           ("proximal", "local"),
                                           ("accelerated", "local")}
    assert T.get_solver("accelerated") is T.ca_accelerated_bcd
    with pytest.raises(KeyError, match="no solver registered"):
        T.get_solver("kernel")
    with pytest.raises(ValueError, match="unknown backend"):
        T.register_solver("primal", "multipod", T.ca_bcd)
    with pytest.raises(KeyError, match="unknown formulation"):
        T.s_step_solve("lasso", T.SolverPlan(b=2), torch.zeros((3, 4)),
                       torch.zeros(4), 1.0, 2, idx=torch.zeros((2, 2)))
    X, y = problem
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    idx = torch.from_numpy(_idx(N))
    by_name = T.s_step_solve("dual", T.SolverPlan(b=B, s=3), Xt, yt, LAM,
                             ITERS, idx=idx)
    by_wrapper = T.ca_bdcd(Xt, yt, LAM, B, 3, ITERS, idx=idx)
    assert torch.equal(by_name.w, by_wrapper.w)


def test_solver_plan_validation():
    for bad in ({"b": 0}, {"b": 2, "s": 0}, {"b": 2.5},
                {"b": 2, "impl": "pallas"}, {"b": 2, "tiles": (32, 64)},
                {"b": 2, "tiles": 0}):
        with pytest.raises(ValueError):
            T.SolverPlan(**bad)
    assert T.SolverPlan(b=4, s=2, impl="cuda", tiles=64).packet == \
        T.engine.PacketPlan("cuda", 64)


def test_interop_round_trip(problem):
    X, y = problem
    idx = _idx(D)
    Xt, yt, it, x0 = problem_from_numpy(X, y, idx, np.zeros(D),
                                        device="cpu", dtype=torch.float32)
    assert Xt.dtype == yt.dtype == x0.dtype == torch.float32
    assert it.dtype == torch.int32 and tuple(it.shape) == idx.shape
    np.testing.assert_array_equal(it.numpy(), idx)
    res = result_to_numpy(T.ca_bcd(Xt, yt, LAM, B, 3, ITERS, idx=it, w0=x0))
    assert isinstance(res, T.SolveResult)
    assert res.w.dtype == np.float32 and res.w.shape == (D,)
    assert res.alpha.shape == (N,) and res.history["objective"].shape == (
        ITERS,)


def test_plan_from_reference_maps_supported_fields():
    ref = JPlan(b=8, s=4, impl="pallas", track_cond=True)
    plan = plan_from_reference(**dataclasses.asdict(ref))
    assert plan == T.SolverPlan(b=8, s=4, impl="cuda", track_cond=True)
    assert plan_from_reference(b=2).impl is None
    assert plan_from_reference(b=2, impl="ref", unroll=4).impl == "ref"
    assert plan_from_reference(b=2, tenants=4).tenants == 4
    ring = plan_from_reference(b=2, wire="ring", fuse_packet=False)
    assert (ring.wire, ring.fuse_packet) == ("ring", False)


@pytest.mark.parametrize("field,value", [
    ("guard", "yes"), ("fault", object()), ("wire", "tree"),
    ("tiles", (128, 512)), ("impl", "pallas_interpret"), ("colour", 1)])
def test_plan_from_reference_refuses_unsupported_fields(field, value):
    with pytest.raises(ValueError, match="not supported"):
        plan_from_reference(b=2, **{field: value})


@pytest.mark.parametrize("shape", [(12, 30), (30, 12)])
def test_ridge_exact_matches_reference(shape):
    rng = np.random.default_rng(6)
    X = rng.standard_normal(shape)
    y = rng.standard_normal(shape[1])
    got = T.ridge_exact(torch.from_numpy(X), torch.from_numpy(y), 0.1)
    want = J.ridge_exact(jnp.asarray(X), jnp.asarray(y), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_objective_and_lam_for_match_reference(problem):
    X, y = problem
    w = np.linspace(-1, 1, D)
    got = T.objective(torch.from_numpy(X), torch.from_numpy(w),
                      torch.from_numpy(y), LAM)
    want = J.objective(jnp.asarray(X), jnp.asarray(w), jnp.asarray(y), LAM)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    from repro.data.regression import lam_for as j_lam_for
    np.testing.assert_allclose(float(lam_for(torch.from_numpy(X))),
                               float(j_lam_for(jnp.asarray(X))), rtol=1e-8)


def test_make_regression_shape_dtype_and_conditioning():
    g = torch.Generator().manual_seed(0)
    spec = SyntheticSpec("t", d=30, n=50, cond=1e4)
    X, y, w = make_regression(g, spec, torch.float64, device="cpu")
    assert X.shape == (30, 50) and y.shape == (50,) and w.shape == (30,)
    assert X.dtype == torch.float64 and X.device.type == "cpu"
    sv = torch.linalg.svdvals(X)
    np.testing.assert_allclose(float((sv[0] / sv[-1]) ** 2), 1e4, rtol=1e-8)
    Xs, _, _ = make_regression(torch.Generator().manual_seed(1),
                               dataclasses.replace(spec, density=0.2),
                               torch.float32, device="cpu")
    frac = float((Xs != 0).float().mean())
    assert Xs.dtype == torch.float32 and 0.1 < frac < 0.3


def test_full_table3_shapes_are_the_cuts_scaled_up():
    full, cut = PAPER_DATASETS_FULL["real-sim"], PAPER_DATASETS["real-sim"]
    assert (full.d, full.n) == (20958, 72309)
    assert (full.cond, full.density) == (cut.cond, cut.density)
    for name, spec in PAPER_DATASETS_FULL.items():
        cut = PAPER_DATASETS[name]
        for full_dim, cut_dim in ((spec.d, cut.d), (spec.n, cut.n)):
            assert full_dim == cut_dim or 7.9 < full_dim / cut_dim < 8.1


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_regression(torch.Generator(), PAPER_DATASETS["abalone"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.main()


def test_quickstart_on_cpu_matches_classical_exactly():
    assert quickstart.main(device="cpu") < 1e-8
