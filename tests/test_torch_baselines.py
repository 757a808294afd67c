"""The port's baselines path against the reference, on the CPU in f64.

Covered: the Gram entry points on a materialised operand (``gram_packet``,
``gram``: K7 / K8's plain versions), ``normal_matvec`` through both of the
port's routes, ``MaterializedOperand``, CG (``cg_ridge``,
``cg_ridge_history``), TSQR and CholeskyQR (``tsqr``, ``cholqr_r``,
``tsqr_ridge`` on both branches).  Inputs are made with numpy from a seed
and handed to both packages.

K7 / K8's plain versions are also held against the reference's Pallas
kernels run in interpret mode (their bodies execute on the CPU); the
reference's kernel route of ``normal_matvec`` goes through the sampled
kernels, whose interpret mode does not run on this jax, so it and CG are
held against the reference's ``impl="ref"``.  Each test states its
tolerance and why.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.kernels import gram as jgk
from repro_torch import core as T
from repro_torch.kernels import gram as gk
from repro_torch.core.tsqr import ridge_operand
from repro_torch.kernels.gram import gram_kernel

from _x64 import x64_mode  # noqa: F401  (autouse fixture)

LAM = 1e-3


def _spectrum_matrix(rng, d, n, cond):
    """X (d, n) with singular values spread geometrically so that
    cond(X X^T) (or X^T X) = ``cond``."""
    r = min(d, n)
    U, _ = np.linalg.qr(rng.standard_normal((d, r)))
    V, _ = np.linalg.qr(rng.standard_normal((n, r)))
    return (U * np.logspace(0.0, -0.5 * np.log10(cond), r)) @ V.T


@pytest.fixture(scope="module")
def problem():
    """The reference solver tests' shape: d = 60 features, n = 200 points,
    cond 1e6."""
    rng = np.random.default_rng(0)
    X = _spectrum_matrix(rng, 60, 200, 1e6)
    y = X.T @ rng.standard_normal(60) + 1e-2 * rng.standard_normal(200)
    return X, y


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


# -- K7 / K8 on a materialised operand --------------------------------------

@pytest.mark.parametrize("shape", [(77, 300), (130, 1000)])
@pytest.mark.parametrize("jimpl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("port", ["ops", "wrapper"])
def test_dense_packet_and_gram_match_reference(shape, jimpl, port):
    """The port's plain versions, through ``ops`` and through the K7 / K8
    wrappers (which take them on a CPU tensor), against the reference's
    ``ref`` and interpret-mode kernels, at shapes that are no multiple of
    any tile, with scale, reg and scale_r set.  rtol / atol 1e-12: the same
    f64 sums in different orders (entries up to about 1e2 here)."""
    m, K = shape
    rng = np.random.default_rng(m)
    A = rng.standard_normal((m, K))
    u = rng.standard_normal(K)
    knobs = {"scale": 1.0 / K, "reg": 0.5}
    Gj, rj = jgk.gram_packet(jnp.asarray(A), jnp.asarray(u), scale_r=2.0,
                             impl=jimpl, **knobs)
    Gj_only = jgk.gram(jnp.asarray(A), impl=jimpl, **knobs)
    if port == "ops":
        Gt, rt = gk.gram_packet(_t(A), _t(u), scale_r=2.0, **knobs)
        Gt_only = gk.gram(_t(A), **knobs)
    else:
        Gt, rt = gk.gram_packet_dense(_t(A), _t(u), scale_r=2.0, **knobs)
        Gt_only = gk.gram_dense(_t(A), **knobs)
    assert Gt.shape == (m, m) and rt.shape == (m,)
    for got, want in ((Gt, Gj), (rt, rj), (Gt_only, Gj_only)):
        assert got.dtype == torch.float64
        _close(got, want, 1e-12, 1e-12)


def test_dense_wrappers_on_cpu_launch_nothing():
    A = torch.ones((3, 5), dtype=torch.float64)
    gk.reset_launch_counts()
    G, r = gk.gram_packet_dense(A, torch.ones(5, dtype=torch.float64))
    assert torch.equal(gk.gram_dense(A), G) and torch.equal(r, G[0])
    assert gk.DENSE_PACKET.launches == gk.DENSE_GRAM.launches == 0


@pytest.mark.parametrize("A,u,err,match", [
    (torch.zeros((7, 5)).T, None, ValueError, "contiguous"),
    (torch.zeros((0, 5)), None, ValueError, "non-empty"),
    (torch.zeros((4, 5), dtype=torch.bfloat16), None, TypeError, "bf16"),
    (torch.zeros(5), None, ValueError, "2-D"),
    (torch.zeros((4, 5)), torch.zeros(4), ValueError, "length"),
    (torch.zeros((4, 5)), torch.zeros(5, dtype=torch.float64), TypeError,
     "dtype"),
    (torch.zeros((4, 5)), torch.zeros((1, 5)), ValueError, "1-D"),
])
def test_dense_operand_checks_refuse_what_the_kernel_cannot_take(A, u, err,
                                                                 match):
    """What the K7 / K8 wrappers check before a launch; A is never copied,
    so a non-contiguous A raises."""
    with pytest.raises(err, match=match):
        m, K = gram_kernel._check_operand(A, "K7")
        gram_kernel.check_vector(A, u, K, "K7", name="u")


@pytest.mark.parametrize("call", ["gram", "gram_packet"])
def test_dense_impl_cuda_on_cpu_tensor_raises(call):
    A = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        if call == "gram":
            gk.gram(A, impl="cuda")
        else:
            gk.gram_packet(A, torch.zeros(4), plan=gk.PacketPlan(impl="cuda"))


# -- normal_matvec and the materialised operand ------------------------------

@pytest.mark.parametrize("impl", [None, "ref", "cuda"])
def test_normal_matvec_matches_reference(problem, impl):
    """Both routes: the dense product (None, "ref") and the K2 -> K6 route
    ("cuda"), whose wrappers run their plain versions on the CPU.  rtol /
    atol 1e-12: two products of at most 200 terms in f64."""
    X, _ = problem
    n = X.shape[1]
    v = np.random.default_rng(18).standard_normal(X.shape[0])
    want = jgk.normal_matvec(jnp.asarray(X), jnp.asarray(v), lam=LAM,
                             scale=1.0 / n, impl="ref")
    gk.reset_launch_counts()
    got = gk.normal_matvec(_t(X), _t(v), lam=LAM, scale=1.0 / n, impl=impl)
    assert [k.launches for k in gk.KERNELS] == [0] * len(gk.KERNELS)
    _close(got, want, 1e-12, 1e-12)


def test_normal_matvec_rejects_unknown_impl():
    with pytest.raises(ValueError, match="unknown gram impl"):
        gk.normal_matvec(torch.zeros((2, 3)), torch.zeros(2), impl="pallas")


def test_materialized_operand_matches_reference():
    """packet / apply / matvec over a kernel matrix K, with duplicate
    indices: gathers and one product each.  rtol / atol 1e-12."""
    rng = np.random.default_rng(4)
    B = rng.standard_normal((30, 12))
    Kmat = B @ B.T
    flat = rng.integers(0, 30, 9).astype(np.int32)
    flat[-1] = flat[0]
    u, v = rng.standard_normal(30), rng.standard_normal(9)
    op_t = gk.MaterializedOperand(_t(Kmat))
    op_j = jgk.MaterializedOperand(jnp.asarray(Kmat))
    assert gk.as_operand(op_t) is op_t and op_t.layout == "materialized"
    ft, fj = _t(flat), jnp.asarray(flat)
    Gt, rt = gk.gram_packet_sampled(op_t, ft, _t(u), scale=0.5, reg=0.25,
                                    scale_r=3.0)
    Gj, rj = jgk.gram_packet_sampled(op_j, fj, jnp.asarray(u), scale=0.5,
                                     reg=0.25, scale_r=3.0, impl="ref")
    _close(Gt, Gj, 1e-12, 1e-12)
    _close(rt, rj, 1e-12, 1e-12)
    _close(gk.panel_apply(op_t, ft, _t(v), scale=2.0),
           jgk.panel_apply(op_j, fj, jnp.asarray(v), scale=2.0, impl="ref"),
           1e-12, 1e-12)
    _close(gk.panel_matvec(op_t, ft, _t(u), scale=2.0),
           jgk.panel_matvec(op_j, fj, jnp.asarray(u), scale=2.0, impl="ref"),
           1e-12, 1e-12)


# -- CG ---------------------------------------------------------------------

@pytest.mark.parametrize("impl", [None, "cuda"])
def test_cg_ridge_matches_reference(problem, impl):
    """To convergence (tol 1e-14): the port's w against the reference's and
    against the direct solve, rtol 1e-9 / atol 1e-11 (the reference's own
    bar for CG against the direct solve, test_core_solvers.py)."""
    X, y = problem
    want = J.cg_ridge(jnp.asarray(X), jnp.asarray(y), LAM, tol=1e-14,
                      max_iters=500, impl="ref")
    got = T.cg_ridge(_t(X), _t(y), LAM, tol=1e-14, max_iters=500, impl=impl)
    assert isinstance(got, T.CGResult) and 0 < got.iters < 500
    assert abs(got.iters - int(want.iters)) <= 1
    _close(got.w, want.w, 1e-9, 1e-11)
    _close(got.w, J.ridge_exact(jnp.asarray(X), jnp.asarray(y), LAM), 1e-9,
           1e-11)


def test_cg_ridge_stops_at_max_iters_and_reports_sol_err(problem):
    X, y = problem
    w_ref = T.ridge_exact(_t(X), _t(y), LAM)
    res = T.cg_ridge(_t(X), _t(y), LAM, tol=0.0, max_iters=7, w_ref=w_ref)
    want = J.cg_ridge(jnp.asarray(X), jnp.asarray(y), LAM, tol=0.0,
                      max_iters=7, w_ref=jnp.asarray(w_ref.numpy()))
    assert res.iters == 7 == int(want.iters)
    _close(res.history["sol_err"], want.history["sol_err"], 1e-9, 0)


@pytest.mark.parametrize("impl", [None, "cuda"])
def test_cg_ridge_history_matches_reference(impl):
    """20 fixed iterations on a Gaussian X (60, 200), where the operator's
    condition is about 12 and CG, still short of convergence (residual about
    6e-7 of the start), contracts steadily: w and the three per-iteration
    series, rtol 1e-9.  (On ``problem``'s geometric spectrum CG reaches its
    rounding floor within 20 iterations, and rounding differences between
    any two implementations then grow to percents.)"""
    rng = np.random.default_rng(1)
    X, y = rng.standard_normal((60, 200)), rng.standard_normal(200)
    w_ref = J.ridge_exact(jnp.asarray(X), jnp.asarray(y), LAM)
    want = J.cg_ridge_history(jnp.asarray(X), jnp.asarray(y), LAM, 20,
                              w_ref=w_ref, impl="ref")
    got = T.cg_ridge_history(_t(X), _t(y), LAM, 20,
                             w_ref=_t(np.array(w_ref)), impl=impl)
    assert got.iters == 20
    assert set(got.history) == {"res_norm", "objective", "sol_err"}
    _close(got.w, want.w, 1e-9, 1e-12)
    for key, series in got.history.items():
        assert series.shape == (20,)
        _close(series, want.history[key], 1e-9, 0)
    obj = got.history["objective"]
    assert bool((obj[1:] <= obj[:-1]).all())      # CG lowers the objective


# -- TSQR and CholeskyQR -----------------------------------------------------

@pytest.mark.parametrize("n_blocks", [1, 3, 8])
def test_tsqr_r_factor_matches_reference(problem, n_blocks):
    """R^T R against A^T A and against the reference's R^T R (R is defined
    up to row signs), rtol / atol 1e-10 as in test_core_solvers.py; a
    ragged row count (200 rows over 8 leaves of 25, padded to 60)."""
    X, _ = problem
    A = X.T
    R = T.tsqr(_t(A), n_blocks=n_blocks)
    Rj = np.asarray(J.tsqr(jnp.asarray(A), n_blocks=n_blocks))
    assert R.shape == (60, 60) and torch.equal(R, torch.triu(R))
    _close(R.T @ R, A.T @ A, 1e-10, 1e-10)
    _close(R.T @ R, Rj.T @ Rj, 1e-10, 1e-10)


@pytest.mark.parametrize("jimpl", ["ref", "pallas_interpret"])
def test_cholqr_r_factor_matches_reference(problem, jimpl):
    """Upper triangular with R^T R = A^T A (rtol / atol 1e-10, as in
    test_gram_dispatch.py), and equal to the reference's R, whose Gram runs
    through ``ref`` or the interpret-mode K8 (rtol 1e-10: one Cholesky of the
    same Gram up to f64 rounding)."""
    X, _ = problem
    A = np.concatenate([X.T, np.eye(60)], axis=0)
    R = T.cholqr_r(_t(A))
    assert torch.equal(R, torch.triu(R))
    _close(R.T @ R, A.T @ A, 1e-10, 1e-10)
    _close(R, J.cholqr_r(jnp.asarray(A), impl=jimpl), 1e-10, 1e-10)


def test_cholqr_r_not_positive_definite_gives_nan():
    A = torch.zeros((6, 3), dtype=torch.float64)
    assert torch.isnan(T.cholqr_r(A)).all()


@pytest.mark.parametrize("branch", ["primal", "dual"])
@pytest.mark.parametrize("method", ["tsqr", "cholqr"])
def test_tsqr_ridge_matches_reference_and_direct(problem, branch, method):
    """Both branches (d <= n, and d > n through the transposed problem) and
    both methods, against the reference's solve and the direct solve:
    rtol 1e-9 / atol 1e-11 for TSQR (test_core_solvers.py), rtol 1e-8 /
    atol 1e-10 for CholeskyQR, which squares the operand's condition
    (test_gram_dispatch.py)."""
    X, y = problem
    if branch == "dual":
        X, y = X.T, np.ones(60)
    rtol, atol = (1e-9, 1e-11) if method == "tsqr" else (1e-8, 1e-10)
    got = T.tsqr_ridge(_t(X), _t(y), LAM, method=method)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    assert got.shape == (X.shape[0],)
    _close(got, J.tsqr_ridge(Xj, yj, LAM, method=method), rtol, atol)
    _close(got, J.ridge_exact(Xj, yj, LAM), rtol, atol)
    _close(got, T.ridge_exact(_t(X), _t(y), LAM), rtol, atol)


def test_ridge_operand_is_the_regularised_operand(problem):
    """The contiguous transpose of the tall operand, on each branch, equal
    to the reference's concatenation (rtol 1e-15: one division per entry)."""
    X, _ = problem
    for Z in (X, X.T):
        d, n = Z.shape
        At = ridge_operand(_t(Z), LAM)
        c = min(d, n)
        assert At.is_contiguous() and At.shape == (c, max(d, n) + c)
        body = Z if d <= n else Z.T
        want = np.concatenate([body / np.sqrt(n), np.sqrt(LAM) * np.eye(c)],
                              axis=1)
        _close(At, want, 1e-15, 0)


def test_tsqr_ridge_rejects_unknown_method(problem):
    X, y = problem
    with pytest.raises(ValueError, match="unknown method"):
        T.tsqr_ridge(_t(X), _t(y), LAM, method="qr")


@pytest.mark.parametrize("branch", ["primal", "dual"])
def test_cholqr_ridge_frees_the_operand_before_the_factor(problem, branch,
                                                          monkeypatch):
    """The CholeskyQR solve holds no reference to its tall operand (7.82 GB
    at real-sim) once the Gram is formed: the Cholesky factor is allocated
    after the operand is freed, so the solve's peak is the operand plus G."""
    import importlib
    import weakref

    tq = importlib.import_module("repro_torch.core.tsqr")   # the module
    seen = {}
    real_operand, real_cholesky = tq.ridge_operand, tq.cholesky_nan

    def operand(X, lam):
        At = real_operand(X, lam)
        seen["operand"] = weakref.ref(At)
        return At

    def cholesky(G):
        seen["alive"] = seen["operand"]() is not None
        return real_cholesky(G)

    monkeypatch.setattr(tq, "ridge_operand", operand)
    monkeypatch.setattr(tq, "cholesky_nan", cholesky)
    X, y = problem
    if branch == "dual":
        X, y = X.T, np.ones(60)
    w = T.tsqr_ridge(_t(X), _t(y), LAM, method="cholqr")
    assert seen["alive"] is False
    _close(w, T.ridge_exact(_t(X), _t(y), LAM), 1e-8, 1e-10)
