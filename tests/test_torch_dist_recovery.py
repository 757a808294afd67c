"""Guards, fault injection and the supervised elastic restart on the port's
sharded and pipelined backends, against the reference's.

The problem and the reference runs are ``torch_dist_ref.py``'s (n = 41,
d = 18, b = 2, s = 3; the reference's sharded psum backend at
``impl="ref"`` in f64 on four host devices, in a process of its own,
started when the module starts).  The port runs on gloo worlds of CPU
ranks.

* The fault matrix {nan_packet, bitflip, drop_shard} x {primal, dual,
  proximal} on shard 1 of 4 trips at the reference's outer step with the
  reference's telemetry (exact), and the iterates agree within rtol 1e-11 /
  atol 1e-13.  A fault aimed at another shard leaves the solve clean.
* On the ring, each fault degrades as on the psum wire: the same telemetry,
  the iterates within the wires' 1e-12.
* The supervised sharded solve loses a device at outer step 2, respawns
  its world on the 3 survivors and resumes from the newest snapshot: the
  reference's restart telemetry (exact), w within 1e-10 of the
  uninterrupted four-rank solve and of the reference's.  A guard trip on
  the sharded backend switches the remaining segments to s = 1 as the
  reference's supervisor does.  The snapshot restores in the reference.
* A rank that fails tears its world down and raises with its traceback.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
import torch_dist_ref as R
from repro.checkpoint import CheckpointManager as JManager
from repro_torch.core import engine
from repro_torch.faults import FaultPlan, solve_supervised

from _x64 import x64_mode  # noqa: F401  (autouse: f64 snapshot cross-read)

RTOL, ATOL = 1e-11, 1e-13
RING_RTOL, RING_ATOL = 1e-12, 1e-14
RESUME_TOL = 1e-10
FAULT_ITERS = 30
REASON = {"nan_packet": engine.GUARD_NONFINITE,
          "bitflip": engine.GUARD_MAGNITUDE,
          "drop_shard": engine.GUARD_SHARD_LOSS}


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "recovery.npz"
    proc = R.start("recovery", out)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_proc):
    return R.load(*ref_proc, timeout=300)


@pytest.fixture(scope="module")
def world(ref_proc):       # the reference starts first and runs meanwhile
    with T.SolverWorld(4, device="cpu", timeout=120) as w:
        yield w


def _data():
    X, y = R.problem()
    return torch.from_numpy(X), torch.from_numpy(y)


def _solve(world, form, iters=FAULT_ITERS, wire="psum", **kw):
    X, y = _data()
    solve = T.get_solver(form, "pipelined" if wire == "ring" else "sharded")
    kw = {**R.form_kwargs(form, X.numpy(), y.numpy()), **kw}
    return solve(world, X, y, R.LAM, R.B, R.S, iters,
                 idx=torch.from_numpy(R.index(form, iters)), **kw)


def _metrics(case: dict, keys) -> dict:
    return {k: case[k].item() for k in keys}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# --------------------------------------------------------------------------
# the fault matrix on one shard
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["nan_packet", "drop_shard"])
def test_a_fault_fires_on_its_shard_only(world, kind):
    """Aimed at shard 3, the fault hits a four-rank solve and misses a
    three-rank one, which then equals the clean solve."""
    fault = FaultPlan(kind, step=2, shard=3)
    *_, hit = _solve(world, "primal", guard=True, fault=fault)
    assert hit["guard_first_trip"] == 2
    three = world.ranks(3)
    w, alpha, m = _solve(three, "primal", guard=True, fault=fault)
    wc, ac = _solve(three, "primal")
    assert m["guard_trips"] == 0
    assert torch.equal(w, wc) and torch.equal(alpha, ac)


def test_fault_hooks_take_the_callers_rank():
    G, r, h = torch.ones(2, 2), torch.ones(2), torch.ones(5)
    plan = FaultPlan("drop_shard", step=1, shard=2)
    assert plan.apply_packet(G, r, step=1, rank=1)[0] is G
    assert plan.apply_health(h, step=1, rank=1) is h
    assert bool((plan.apply_packet(G, r, step=1, rank=2)[0] == 0).all())
    assert bool((plan.apply_health(h, step=1, rank=2) == 0).all())
    assert bool((plan.apply_health(h, step=1) == 0).all())     # local: hit


@pytest.mark.parametrize("kind,step", R.FAULTS)
@pytest.mark.parametrize("form", ["primal", "dual"])
def test_ring_degrades_as_the_psum_wire(world, form, kind, step):
    fault = FaultPlan(kind, step=step, shard=R.FAULT_SHARD)
    wp, ap, mp = _solve(world, form, guard=True, fault=fault)
    wr, ar, mr = _solve(world, form, wire="ring", guard=True, fault=fault)
    assert mr == mp
    _close(wr, wp, RING_RTOL, RING_ATOL)
    _close(ar, ap, RING_RTOL, RING_ATOL)


# --------------------------------------------------------------------------
# the supervised elastic restart
# --------------------------------------------------------------------------

SUP_KEYS = ("segments", "restarts", "guard_trips", "resumed_from_iter",
            "final_n_shards", "final_s")
SUP_CASES = ["sup_primal_29", "sup_dual_30"]      # a ragged tail, an even


@pytest.fixture(scope="module")
def supervised(ref_proc, tmp_path_factory):
    """The port's supervised runs of ``torch_dist_ref``'s cases, made
    while the reference runs: each device loss respawns its world (four
    ranks) on the three survivors."""
    X, y = _data()
    out = {}
    for case in SUP_CASES:
        _, form, iters = case.split("_")
        ckpt = tmp_path_factory.mktemp(case)
        with T.SolverWorld(4, device="cpu", timeout=120) as sup_world:
            first = list(sup_world.pids)
            res = solve_supervised(
                form, "sharded", X, y, R.LAM, R.B, R.S, int(iters),
                idx=torch.from_numpy(R.index(form, int(iters))),
                ckpt_dir=str(ckpt), world=sup_world,
                fault=FaultPlan("device_loss", step=2, survivors=3))
            respawned = (sup_world.size == 3
                         and not set(sup_world.pids) & set(first))
        out[case] = (res, ckpt, respawned)
    ckpt = tmp_path_factory.mktemp("sup_primal_nan")
    with T.SolverWorld(4, device="cpu", timeout=120) as sup_world:
        out["sup_primal_nan"] = (solve_supervised(
            "primal", "sharded", X, y, R.LAM, R.B, R.S, FAULT_ITERS,
            idx=torch.from_numpy(R.index("primal", FAULT_ITERS)),
            ckpt_dir=str(ckpt), world=sup_world, ckpt_every=4,
            fault=FaultPlan("nan_packet", step=2, shard=R.FAULT_SHARD)),
            ckpt, sup_world.size == 4)
    return out


@pytest.mark.parametrize("case", SUP_CASES)
def test_supervised_sharded_restart_resumes(world, supervised, case):
    """One respawn onto the survivors, a resume from a snapshot, and w
    within 1e-10 of the uninterrupted four-rank solve; the snapshot is the
    logical iterate in the reference's format."""
    res, ckpt, respawned = supervised[case]
    _, form, iters = case.split("_")
    assert respawned
    assert res.metrics["restarts"] == 1 and res.metrics["final_n_shards"] == 3
    assert res.metrics["resumed_from_iter"] > 0
    wu, au = _solve(world, form, int(iters))
    np.testing.assert_allclose(res.w.numpy(), wu.numpy(), rtol=0,
                               atol=RESUME_TOL)
    np.testing.assert_allclose(res.alpha.numpy(), au.numpy(), rtol=0,
                               atol=RESUME_TOL)
    import jax
    x0 = res.w if form == "primal" else res.alpha
    restored, extra, _ = JManager(str(ckpt)).restore_latest(
        {"x0": jax.ShapeDtypeStruct(tuple(x0.shape), np.float64)})
    assert extra["iters_done"] == int(iters)
    assert np.array_equal(np.asarray(restored["x0"]), x0.numpy())


def test_supervised_guard_trip_takes_rung_two(supervised):
    """A NaN packet on shard 1 at outer step 2 trips its segment, and the
    remaining segments run at s = 1, on the caller's world, which keeps
    its four ranks."""
    res, _, kept = supervised["sup_primal_nan"]
    assert kept
    assert res.metrics["final_s"] == 1 and res.metrics["guard_trips"] >= 1
    assert res.metrics["restarts"] == 0
    assert bool(torch.isfinite(res.w).all())


# --------------------------------------------------------------------------
# failures
# --------------------------------------------------------------------------

def test_a_failing_rank_tears_the_world_down():
    X, y = _data()
    w = T.SolverWorld(2, device="cpu", timeout=60)
    procs = list(w._procs)
    bad = torch.full((4, R.B), R.D + 7, dtype=torch.int32)  # out of range
    with pytest.raises(RuntimeError, match="rank [01] failed"):
        T.ca_bcd_sharded(w, X, y, R.LAM, R.B, 2, 4, idx=bad)
    assert w.size == 0 and not any(p.is_alive() for p in procs)
    with pytest.raises(RuntimeError, match="closed"):
        T.ca_bcd_sharded(w, X, y, R.LAM, R.B, 2, 4, idx=bad)


# --------------------------------------------------------------------------
# against the reference (which has run meanwhile)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", SUP_CASES + ["sup_primal_nan"])
def test_supervised_sharded_matches_reference(ref, supervised, case):
    res, *_ = supervised[case]
    want = ref[case]
    assert res.metrics == _metrics(want, SUP_KEYS)
    np.testing.assert_allclose(res.w.numpy(), want["w"], rtol=0,
                               atol=RESUME_TOL)
    np.testing.assert_allclose(res.alpha.numpy(), want["alpha"], rtol=0,
                               atol=RESUME_TOL)


@pytest.mark.parametrize("kind,step", R.FAULTS)
@pytest.mark.parametrize("form", ["primal", "dual", "proximal"])
def test_fault_matrix_on_a_shard_matches_reference(world, ref, form, kind,
                                                   step):
    fault = FaultPlan(kind, step=step, shard=R.FAULT_SHARD)
    w, alpha, m = _solve(world, form, guard=True, fault=fault)
    want = ref[f"fault_{form}_{kind}"]
    assert m == _metrics(want, m)
    assert m["guard_first_trip"] == step and m["guard_trips"] >= 1
    assert m["guard_first_reason"] & REASON[kind]
    _close(w, want["w"])
    _close(alpha, want["alpha"])
