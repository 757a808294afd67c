"""The port's continuous-batching solve service against the reference's.

Both services get the same X, requests and index chunks: ``sample_blocks``
is replaced in ``repro.serve.solver_service`` and in
``repro_torch.serve.solver_service`` by one stream of numpy chunks, so the
two draw identical blocks step by step (nothing in the reference changes).
The reference runs ``impl="ref"`` in f64.  Every ticket's w and alpha agree
within rtol 1e-10 / atol 1e-12 (XLA and ATen sum in different orders, a few
ulps apart); iters and converged are equal.

The two service tests of the reference are ported as they stand: requests
converge to the closed-form ridge solution (relative 1e-4, the reference's
bound after 480 iterations in f32), and dual tolerance retirement frees
oversubscribed slots.  The port's own tickets are also replayed as single
solves over the chunks of their steps, under ``torch.equal``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
import repro.serve.solver_service as jsvc
import repro.serve.slots as jslots
import repro_torch.serve.solver_service as tsvc
from repro_torch import core as T
from repro_torch.serve import slots as tslots

from _x64 import x64_mode  # noqa: F401  (autouse fixture)

RTOL, ATOL = 1e-10, 1e-12
D, N, B, S = 24, 40, 4, 3


def _problem(npdt=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((D, N)).astype(npdt)
    ys = rng.standard_normal((6, N)).astype(npdt)
    return X, ys


class _Chunks:
    """One fixed stream of index chunks, drawn in order by whichever
    service calls it; records what it handed out."""

    def __init__(self, dim, chunk, seed, convert):
        self.rng = np.random.default_rng(seed)
        self.dim, self.chunk, self.convert = dim, chunk, convert
        self.drawn = []

    def __call__(self, key, n_total, b, iters):
        assert (n_total, iters) == (self.dim, self.chunk)
        idx = np.stack([self.rng.choice(n_total, b, replace=False)
                        for _ in range(iters)]).astype(np.int32)
        self.drawn.append(idx)
        return self.convert(idx)


def _serve_both(monkeypatch, form, cfg_kw, requests, X):
    dim = N if form == "dual" else D
    chunk = cfg_kw["chunk_iters"]
    monkeypatch.setattr(jsvc, "sample_blocks",
                        _Chunks(dim, chunk, 5, jnp.asarray))
    port_chunks = _Chunks(dim, chunk, 5, torch.from_numpy)
    monkeypatch.setattr(tsvc, "sample_blocks", port_chunks)
    ref = jsvc.SolverService(jnp.asarray(X),
                             J.SolverPlan(b=B, s=S, impl="ref"), form,
                             jsvc.SolverServiceConfig(**cfg_kw))
    port = tsvc.SolverService(torch.from_numpy(X), T.SolverPlan(b=B, s=S),
                              form, tsvc.SolverServiceConfig(**cfg_kw))
    rids = []
    for y, lam, kw in requests:
        rids.append((ref.submit(y, lam, **kw), port.submit(y, lam, **kw)))
    return ref, port, rids, ref.serve(), port.serve(), port_chunks


@pytest.mark.parametrize("form,kw", [
    ("primal", {}), ("dual", {"tol": 5e-3}), ("proximal", {})])
def test_service_matches_reference(monkeypatch, form, kw):
    """Six requests through four slots, mixed lam (and lam1), chunks of 9
    iterations (a ragged outer step each), a cap of 27 iterations."""
    X, ys = _problem()
    requests = []
    for i in range(6):
        extra = dict(kw)
        if form == "proximal":
            extra["lam1"] = 0.01 * (i + 1)
        requests.append((ys[i], 0.1 + 0.3 * i, extra))
    ref, port, rids, done_r, done_p, _ = _serve_both(
        monkeypatch, form, dict(slots=4, min_bucket=2, chunk_iters=9,
                                max_iters=27), requests, X)
    assert sorted(done_p) == sorted(r for _, r in rids)
    for rid_r, rid_p in rids:
        tr, tp = ref.result(rid_r), port.result(rid_p)
        assert (tp.iters, tp.converged) == (tr.iters, tr.converged)
        np.testing.assert_allclose(tp.w, tr.w, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tp.alpha, tr.alpha, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tp.residual, tr.residual, rtol=1e-8)
    if form == "dual":
        assert any(port.result(r).converged for _, r in rids)


@pytest.mark.parametrize("form", ["primal", "dual"])
def test_tickets_equal_replayed_single_solves(monkeypatch, form):
    """Each ticket equals one single solve over the chunks of the steps it
    was live for, bit for bit (f32).  The chunk is a multiple of s, so the
    chunks group the outer steps as the single solve does."""
    X, ys = _problem(np.float32)
    dim = N if form == "dual" else D
    chunks = _Chunks(dim, 3 * S, 9, torch.from_numpy)
    monkeypatch.setattr(tsvc, "sample_blocks", chunks)
    svc = tsvc.SolverService(
        torch.from_numpy(X), T.SolverPlan(b=B, s=S), form,
        tsvc.SolverServiceConfig(slots=2, min_bucket=2, chunk_iters=3 * S,
                                 max_iters=6 * S))
    rids = [svc.submit(ys[i], 0.2 + 0.1 * i) for i in range(5)]
    first = {}
    while svc.table.pending or svc.table.any_active:
        svc.step()
        for rid in rids:
            if svc.table.requests[rid].slot >= 0:
                first.setdefault(rid, len(chunks.drawn) - 1)
    for i, rid in enumerate(rids):
        ticket = svc.result(rid)
        k0 = first[rid]
        steps = ticket.iters // (3 * S)
        idx = torch.from_numpy(np.concatenate(chunks.drawn[k0:k0 + steps]))
        single = T.s_step_solve(form, T.SolverPlan(b=B, s=S),
                                torch.from_numpy(X), torch.from_numpy(ys[i]),
                                0.2 + 0.1 * i, ticket.iters, idx=idx)
        assert torch.equal(torch.from_numpy(ticket.w), single.w)
        assert torch.equal(torch.from_numpy(ticket.alpha), single.alpha)


def test_solver_service_converges_to_exact():
    """Requests stream through slots, chunks and retirement and land on the
    closed-form ridge solution (the reference's test, ported)."""
    X, ys = _problem(np.float32)
    Xt = torch.from_numpy(X)
    lams = (0.1, 0.5, 1.0)
    svc = tsvc.SolverService(Xt, T.SolverPlan(b=B, s=S), "primal",
                             tsvc.SolverServiceConfig(slots=4, min_bucket=2,
                                                      chunk_iters=48,
                                                      max_iters=480))
    rids = [svc.submit(ys[t], lams[t]) for t in range(3)]
    done = svc.serve()
    assert sorted(done) == sorted(rids)
    for t, rid in enumerate(rids):
        ticket = svc.result(rid)
        assert ticket.iters == 480 and not ticket.converged
        w_exact = T.ridge_exact(Xt, torch.from_numpy(ys[t]), lams[t]).numpy()
        err = np.linalg.norm(ticket.w - w_exact) / np.linalg.norm(w_exact)
        assert err < 1e-4, (t, err)


def test_solver_service_tol_retirement_oversubscribed():
    """More requests than slots; the dual's residual is a convergence
    statistic, so per-request tolerances retire tenants early and free
    slots for the queue (the reference's test, ported)."""
    X, _ = _problem(np.float32)
    rng = np.random.default_rng(20)
    svc = tsvc.SolverService(torch.from_numpy(X), T.SolverPlan(b=B, s=S),
                             "dual",
                             tsvc.SolverServiceConfig(slots=2, min_bucket=2,
                                                      chunk_iters=64,
                                                      max_iters=1280))
    rids = [svc.submit(rng.standard_normal(N).astype(np.float32),
                       0.3 + 0.2 * i, tol=1e-4) for i in range(4)]
    done = svc.serve()
    assert sorted(done) == sorted(rids)
    for rid in rids:
        t = svc.result(rid)
        assert t.converged and t.residual <= 1e-4 and t.iters < 1280


def test_service_refusals_and_defaults():
    X = torch.zeros((D, N))
    with pytest.raises(ValueError, match="min_bucket"):
        tsvc.SolverService(X, T.SolverPlan(b=B), "primal",
                           tsvc.SolverServiceConfig(slots=2, min_bucket=4))
    with pytest.raises(ValueError, match="tenants"):
        tsvc.SolverService(X, T.SolverPlan(b=B, tenants=4))
    svc = tsvc.SolverService(X, T.SolverPlan(b=B), "proximal",
                             tsvc.SolverServiceConfig(slots=2, min_bucket=1))
    with pytest.raises(ValueError, match="y shape"):
        svc.submit(np.zeros(N + 1), 1.0)
    rid = svc.submit(np.zeros(N), 1.0, lam1=0.1)
    with pytest.raises(ValueError, match="coefficient names"):
        svc.submit(np.zeros(N), 1.0)
    assert svc.result(rid) is None
    assert svc.step() == {} or svc.table.any_active
    assert svc.serve(max_steps=0) == {}


@pytest.mark.parametrize("n,lo,cap", [(0, 1, 8), (1, 1, 8), (3, 2, 64),
                                      (9, 8, 64), (65, 8, 64), (5, 8, 4)])
def test_bucket_pow2_matches_reference(n, lo, cap):
    assert tslots.bucket_pow2(n, lo, cap) == jslots.bucket_pow2(n, lo, cap)


def test_slot_table_matches_reference():
    tables = (tslots.SlotTable(3), jslots.SlotTable(3))
    for tb in tables:
        for p in range(5):
            tb.submit(p)
    trace = []
    for tb in tables:
        seq = [[r.rid for r in tb.admit()]]
        seq.append(tb.retire(1).rid)
        seq.append(tb.retire(1))
        seq.append([r.rid for r in tb.admit()])
        seq.append((tb.active_slots(), tb.pending, tb.any_active,
                    tb.request_in(0).rid))
        trace.append(seq)
    assert trace[0] == trace[1]
    with pytest.raises(ValueError):
        tslots.SlotTable(0)
    with pytest.raises(KeyError):
        tslots.SlotTable(1).request_in(0)
    with pytest.raises(ValueError):
        tslots.bucket_pow2(-1, 1, 4)
