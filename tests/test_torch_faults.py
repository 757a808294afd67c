"""The port's health guards, fault injection and supervised restart against
the reference's, on the local backend.

Both sides get the same numpy problem (the reference's own fault-test size,
d = 16, n = 40, b = 2, s = 3, 30 iterations) and the same explicit index
stream, in f64, the reference at ``impl="ref"``.

* A guarded clean solve equals an unguarded one under ``torch.equal`` for
  the primal, dual, proximal and accelerated formulations.
* The fault matrix {nan_packet, bitflip, drop_shard} x {primal, dual,
  proximal} trips at the reference's outer step with the reference's reason
  bits and s = 1 tail (exact), and its iterates agree within rtol 1e-10 /
  atol 1e-12.
* The jitter ladder picks the reference's jitter (exact: both are the same
  level times the same scale).
* The supervised local resume matches the reference's restart telemetry,
  and its w is within 1e-10 of the uninterrupted solve's.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
from repro.core import engine as jengine
from repro.core import subproblem as jsub
from repro.faults import FaultPlan as JFault
from repro.faults import solve_supervised as j_supervised
from repro_torch import core as T
from repro_torch.core import engine, subproblem
from repro_torch.faults import (DeviceLostError, FaultPlan, KINDS,
                                solve_supervised)
from repro_torch.interop import fault_from_reference, plan_from_reference

from _x64 import x64_mode  # noqa: F401  (autouse fixture)

RTOL, ATOL = 1e-10, 1e-12
D, N, B, S, ITERS = 16, 40, 2, 3, 30
LAM = 1e-2

# (reference solver, port solver, sampled dimension, extra kwargs)
SOLVERS = {
    "primal": (J.ca_bcd, T.ca_bcd, D, {}),
    "dual": (J.ca_bdcd, T.ca_bdcd, N, {}),
    "proximal": (J.ca_proximal_bcd, T.ca_proximal_bcd, D, {"lam1": 1e-3}),
    "accelerated": (J.ca_accelerated_bcd, T.ca_accelerated_bcd, D,
                    {"beta": 0.5}),
}
# The divergence and magnitude guards arm off one clean step, so the bit
# flip fires at step 1 (as in the reference's tests).
KIND_STEP_REASON = [("nan_packet", 2, engine.GUARD_NONFINITE),
                    ("bitflip", 1, engine.GUARD_MAGNITUDE),
                    ("drop_shard", 2, engine.GUARD_SHARD_LOSS)]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return rng.standard_normal((D, N)), rng.standard_normal(N)


def _idx(dim, iters=ITERS, seed=2):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(dim, B, replace=False)
                     for _ in range(iters)]).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _host(metrics) -> dict:
    return {k: np.asarray(v).item() for k, v in metrics.items()}


def _both(form, X, y, idx, iters=ITERS, s=S, **kw):
    jsolve, tsolve, _, extra = SOLVERS[form]
    jfault = kw.pop("fault", None)
    ref = jsolve(jnp.asarray(X), jnp.asarray(y), LAM, B, s, iters, None,
                 idx=jnp.asarray(idx), impl="ref", fault=jfault, **extra,
                 **kw)
    got = tsolve(_t(X), _t(y), LAM, B, s, iters, idx=_t(idx),
                 fault=None if jfault is None else fault_from_reference(
                     jfault), **extra, **kw)
    return ref, got


def _assert_iterates(got, ref):
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(ref.alpha),
                               rtol=RTOL, atol=ATOL)
    assert sorted(got.history) == sorted(ref.history)
    for key, series in ref.history.items():
        np.testing.assert_allclose(got.history[key].numpy(),
                                   np.asarray(series), rtol=RTOL, atol=ATOL,
                                   err_msg=key)


# --------------------------------------------------------------------------
# the guard on clean solves
# --------------------------------------------------------------------------

@pytest.mark.parametrize("form", sorted(SOLVERS))
def test_guard_is_bitwise_noop_on_clean_solves(data, form):
    X, y = data
    _, tsolve, dim, extra = SOLVERS[form]
    idx = _t(_idx(dim))
    plain = tsolve(_t(X), _t(y), LAM, B, S, ITERS, idx=idx, **extra)
    guarded = tsolve(_t(X), _t(y), LAM, B, S, ITERS, idx=idx, guard=True,
                     **extra)
    assert torch.equal(plain.w, guarded.w)
    assert torch.equal(plain.alpha, guarded.alpha)
    for key, series in plain.history.items():
        assert torch.equal(series, guarded.history[key]), key
    assert plain.metrics == {}
    m = _host(guarded.metrics)
    assert m == {"guard_trips": 0, "guard_first_trip": -1,
                 "guard_first_reason": 0, "guard_max_jitter": 0.0}
    assert set(guarded.history) - set(plain.history) == {
        "guard_tripped", "guard_reason", "guard_jitter"}


@pytest.mark.parametrize("form", sorted(SOLVERS))
def test_guarded_clean_solve_matches_reference(data, form):
    X, y = data
    ref, got = _both(form, X, y, _idx(SOLVERS[form][2]), guard=True)
    assert _host(got.metrics) == _host(ref.metrics)
    _assert_iterates(got, ref)


# --------------------------------------------------------------------------
# the fault matrix
# --------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["dual", "primal", "proximal"])
@pytest.mark.parametrize("kind,step,reason", KIND_STEP_REASON,
                         ids=lambda v: str(v))
def test_fault_matrix_matches_reference(data, form, kind, step, reason):
    """Each fault trips AT its outer step with the reference's reason bits,
    engages the s = 1 tail there, and the degraded solve stays within 1.25
    times the clean objective."""
    X, y = data
    idx = _idx(SOLVERS[form][2])
    ref, got = _both(form, X, y, idx, guard=True,
                     fault=JFault(kind, step=step))
    m, mr = _host(got.metrics), _host(ref.metrics)
    assert m == mr
    assert m["guard_first_trip"] == step and m["guard_trips"] >= 1
    assert int(m["guard_first_reason"]) & reason
    assert m["s1_tail_from_outer"] == step
    assert m["s1_tail_from_iter"] == step * S
    _assert_iterates(got, ref)
    _, tsolve, _, extra = SOLVERS[form]
    clean = tsolve(_t(X), _t(y), LAM, B, S, ITERS, idx=_t(idx), **extra)
    lam1 = extra.get("lam1", 0.0)
    o_clean = float(T.elastic_net_objective(_t(X), clean.w, _t(y), LAM, lam1))
    o_fault = float(T.elastic_net_objective(_t(X), got.w, _t(y), LAM, lam1))
    assert np.isfinite(o_fault) and o_fault <= o_clean * 1.25 + 1e-6


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("sb", [2, 6, 8])
def test_bitflip_hits_the_reference_entry(seed, sb):
    """The port's bit flip changes the reference's (i, j) by the reference's
    amount."""
    G = np.arange(sb * sb, dtype=np.float64).reshape(sb, sb) / 7
    r = np.ones(sb)
    Gj, _ = JFault("bitflip", step=1, seed=seed).apply_packet(
        jnp.asarray(G), jnp.asarray(r), step=1, axis=None)
    plan = FaultPlan("bitflip", step=1, seed=seed)
    Gt, rt = plan.apply_packet(_t(G), _t(r), step=1)
    (i,), (j,) = np.nonzero(np.asarray(Gj) != G)
    assert plan.bitflip_entry((sb, sb)) == (i, j)
    assert np.array_equal(Gt.numpy(), np.asarray(Gj))
    assert torch.equal(rt, _t(r))
    same = plan.apply_packet(_t(G), _t(r), step=0)
    assert torch.equal(same[0], _t(G))           # fires at its step only


def test_device_loss_is_inert_in_the_step(data):
    X, y = data
    idx = _t(_idx(D))
    plain = T.ca_bcd(_t(X), _t(y), LAM, B, S, ITERS, idx=idx)
    lost = T.ca_bcd(_t(X), _t(y), LAM, B, S, ITERS, idx=idx, guard=True,
                    fault=FaultPlan("device_loss", step=1))
    assert torch.equal(plain.w, lost.w)


# --------------------------------------------------------------------------
# the jitter ladder and the rescue
# --------------------------------------------------------------------------

def _rank_deficient(X):
    """The reference's duplicate-index block at lam = 0: rank 2, sb = 8."""
    flat = np.array([3, 3, 3, 3, 5, 5, 5, 5])
    Y = X[flat, :]
    return Y @ Y.T / N


@pytest.mark.parametrize("case", ["rank_deficient", "spd", "negative",
                                  "nonfinite"])
def test_choose_jitter_matches_reference(data, case):
    X, _ = data
    A = {"rank_deficient": _rank_deficient(X),
         "spd": X @ X.T / N + LAM * np.eye(D),
         "negative": -np.eye(4),
         "nonfinite": np.full((3, 3), np.nan)}[case]
    jit_r, ok_r = jsub.choose_jitter(jnp.asarray(A))
    jit_t, ok_t = subproblem.choose_jitter(_t(A))
    assert bool(ok_t) == bool(ok_r)
    np.testing.assert_array_equal(jit_t.numpy(), np.asarray(jit_r))
    assert subproblem.JITTER_LEVELS == jsub.JITTER_LEVELS


def test_solve_spd_jittered_rank_deficient_block(data):
    X, _ = data
    A = _rank_deficient(X)
    rhs = np.ones(8)
    assert not bool(torch.isfinite(T.solve_spd(_t(A), _t(rhs))).all())
    x, jitter, ok = subproblem.solve_spd_jittered(_t(A), _t(rhs))
    xr, jr, okr = jsub.solve_spd_jittered(jnp.asarray(A), jnp.asarray(rhs))
    assert bool(ok) and bool(okr) and float(jitter) > 0
    assert float(jitter) == float(jr)
    # The jittered block is still ill conditioned (cond near 1 / jitter), so
    # the two packages' solutions differ far above an ulp; each must solve
    # it to a backward error of a few ulps of ||A|| ||x||.
    Aj = A + float(jitter) * np.eye(8)
    for sol in (x.numpy(), np.asarray(xr)):
        res = np.linalg.norm(Aj @ sol - rhs)
        assert res <= 1e-12 * np.linalg.norm(Aj) * np.linalg.norm(sol)


def test_guarded_solve_survives_duplicate_indices_at_lam0(data):
    """The rank-deficient duplicate-index stream at lam = 0, s = 4: the
    unguarded CA solve gives NaN, the guard rescues it with a jitter."""
    X, y = data
    idx = np.tile(np.array([[3, 3], [5, 5]], np.int32), (6, 1))
    bad = T.ca_bcd(_t(X), _t(y), 0.0, B, 4, 12, idx=_t(idx))
    assert not bool(torch.isfinite(bad.w).all())
    res = T.ca_bcd(_t(X), _t(y), 0.0, B, 4, 12, idx=_t(idx), guard=True)
    assert bool(torch.isfinite(res.w).all())
    m = _host(res.metrics)
    assert m["guard_trips"] >= 1 and m["guard_max_jitter"] > 0
    assert float(T.objective(_t(X), res.w, _t(y), 0.0)) < float(
        T.objective(_t(X), torch.zeros_like(res.w), _t(y), 0.0))
    ref = J.ca_bcd(jnp.asarray(X), jnp.asarray(y), 0.0, B, 4, 12, None,
                   idx=jnp.asarray(idx), guard=True, impl="ref")
    assert m == _host(ref.metrics)
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), rtol=1e-8,
                               atol=1e-10)


# --------------------------------------------------------------------------
# validation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    {"kind": "meteor_strike", "step": 0}, {"kind": "nan_packet", "step": -1},
    {"kind": "bitflip", "step": 0, "shard": -1}])
def test_fault_plan_validation(bad):
    with pytest.raises(ValueError):
        FaultPlan(**bad)


@pytest.mark.parametrize("bad", [
    {"fault": object()}, {"guard_boost": 1.0}, {"guard": 1},
    {"guard_cond_max": 0.5}])
def test_solver_plan_guard_validation(bad):
    with pytest.raises(ValueError):
        T.SolverPlan(b=2, s=2, **bad)


def test_fault_from_reference_and_plan_mapping():
    jf = JFault("bitflip", step=3, shard=1, seed=5, survivors=2)
    assert fault_from_reference(jf) == FaultPlan("bitflip", 3, 1, 5, 2)
    ref = jengine.SolverPlan(b=4, s=2, guard=True, guard_boost=50.0,
                             guard_cond_max=1e6, fault=jf)
    plan = plan_from_reference(**dataclasses.asdict(ref))
    assert plan == T.SolverPlan(b=4, s=2, guard=True, guard_boost=50.0,
                                guard_cond_max=1e6,
                                fault=FaultPlan("bitflip", 3, 1, 5, 2))
    assert set(KINDS) == {"nan_packet", "bitflip", "drop_shard",
                          "device_loss"}


@pytest.mark.parametrize("kind", ["nan_packet", "drop_shard"])
def test_packet_hooks_fire_at_their_step_only(kind):
    G, r, h = torch.ones(2, 2), torch.ones(2), torch.ones(5)
    plan = FaultPlan(kind, step=3)
    Gs, rs = plan.apply_packet(G, r, step=2)
    assert Gs is G and rs is r
    assert plan.apply_health(h, step=2) is h
    Gf, rf = plan.apply_packet(G, r, step=3)
    bad = torch.isnan if kind == "nan_packet" else (lambda x: x == 0)
    assert bool(bad(Gf).all()) and bool(bad(rf).all())
    assert bool((plan.apply_health(h, step=3) == 0).all()) == (
        kind == "drop_shard")


@pytest.mark.parametrize("knob", [{"guard": True},
                                  {"fault": FaultPlan("nan_packet", 0)}])
def test_batched_engine_refuses_guard_and_fault(data, knob):
    X, y = data
    batch = T.TenantBatch(ys=_t(np.stack([y, y])), lams=[LAM, LAM])
    with pytest.raises(ValueError, match="batched solves do not support"):
        T.s_step_solve_batched("primal", T.SolverPlan(b=B, s=2, **knob),
                               _t(X), batch, 4, idx=_t(_idx(D, 4)))


# --------------------------------------------------------------------------
# supervised solves (local backend)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("iters", [30, 29])           # even, ragged
def test_supervised_local_device_loss_resumes(data, tmp_path, iters):
    X, y = data
    idx = _idx(D, iters)
    fault = JFault("device_loss", step=4)
    res = solve_supervised("primal", "local", _t(X), _t(y), LAM, B, S, iters,
                           idx=_t(idx), ckpt_dir=str(tmp_path / "port"),
                           fault=fault_from_reference(fault))
    ref = j_supervised("primal", "local", jnp.asarray(X), jnp.asarray(y),
                       LAM, B, S, iters, None, idx=jnp.asarray(idx),
                       ckpt_dir=str(tmp_path / "ref"), fault=fault,
                       impl="ref")
    assert res.metrics == ref.metrics
    assert res.metrics["restarts"] == 1
    assert res.metrics["resumed_from_iter"] > 0
    clean = T.ca_bcd(_t(X), _t(y), LAM, B, S, iters, idx=_t(idx))
    np.testing.assert_allclose(res.w.numpy(), clean.w.numpy(), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(res.w.numpy(), np.asarray(ref.w), rtol=0,
                               atol=1e-10)


def test_supervised_dual_resume_goes_back_to_the_device(data, tmp_path):
    X, y = data
    idx = _idx(N)
    res = solve_supervised("dual", "local", _t(X), _t(y), LAM, B, S, ITERS,
                           idx=_t(idx), ckpt_dir=str(tmp_path),
                           fault=FaultPlan("device_loss", step=5))
    clean = T.ca_bdcd(_t(X), _t(y), LAM, B, S, ITERS, idx=_t(idx))
    assert res.metrics["restarts"] == 1
    assert res.alpha.device == clean.alpha.device
    np.testing.assert_allclose(res.alpha.numpy(), clean.alpha.numpy(),
                               rtol=0, atol=1e-10)


def test_supervised_restart_budget_exhausted(data, tmp_path):
    X, y = data
    with pytest.raises(DeviceLostError):
        solve_supervised("primal", "local", _t(X), _t(y), LAM, B, S, ITERS,
                         idx=_t(_idx(D)), ckpt_dir=str(tmp_path),
                         max_restarts=0,
                         fault=FaultPlan("device_loss", step=0))


def test_supervised_refuses_the_sharded_backend(data, tmp_path):
    """Without a world the sharded backend is refused (its runs are in
    test_torch_dist_recovery.py)."""
    X, y = data
    with pytest.raises(ValueError, match="needs a SolverWorld"):
        solve_supervised("primal", "sharded", _t(X), _t(y), LAM, B, S, ITERS,
                         idx=_t(_idx(D)), ckpt_dir=str(tmp_path))
