"""The port's sharded and pipelined backends against the reference's.

One module-scoped gloo :class:`SolverWorld` of four CPU ranks serves every
case; ``world.ranks(P)`` runs a case on P in {1, 2, 3, 4} of them, so both
pads (n = 41, d = 18: n % 4 = 1, d % 4 = 2) and a hop-free group of one are
covered.  The reference runs in a process of its own
(``torch_dist_ref.py``: the JAX package's sharded psum backend at
``impl="ref"``, f64, four host devices), started when the module starts.

Tolerances:

* port sharded against the reference's sharded and local solves: rtol
  1e-11, atol 1e-13 (the reference's own bar between its sharded and local
  solves, ``dist_checks.py``);
* the port's ring against the reference's psum: rtol 1e-12, atol 1e-14
  (the reference's bar between its two wires; its own ring does not run on
  this tree's jax);
* guard telemetry: exact.

Port against port, under ``torch.equal``: a guarded clean solve equals an
unguarded one, the accelerated solve at beta = 0 the primal, the proximal
at lam1 = 0 the ridge solve -- each pair has one packet layout.  Two pairs
do not share a layout: the fused and unfused packets, and a batched packet
(``sb^2 + T sb`` words) against a single solve's (``sb (sb + 1) + 5``).
gloo's all-reduce sums an element in an order set by its offset and the
buffer's length, so these are equal bit for bit at P <= 2, where a sum of
two is one rounding either way, and within 1e-13 beyond.
"""
import math

import numpy as np
import pytest
import torch

import repro_torch.core as T
import torch_dist_ref as R
from repro_torch.core import engine

RTOL, ATOL = 1e-11, 1e-13
RING_RTOL, RING_ATOL = 1e-12, 1e-14
ORDER_TOL = 1e-13          # two packet layouts summed in different orders


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "distributed.npz"
    proc = R.start("distributed", out)
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


@pytest.fixture(scope="module")
def data():
    X, y = R.problem()
    return torch.from_numpy(X), torch.from_numpy(y)


def _solve(world, form, P, *, s=R.S, iters=R.ITERS, wire="psum", **kw):
    X, y = R.problem()
    solve = T.get_solver(form, "pipelined" if wire == "ring" else "sharded")
    kw = {**R.form_kwargs(form, X, y), **kw}
    return solve(world.ranks(P), torch.from_numpy(X), torch.from_numpy(y),
                 R.LAM, R.B, s, iters,
                 idx=torch.from_numpy(R.index(form, iters)), **kw)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _steps(iters, s):
    """The width sb of each outer step (the ragged tail last)."""
    return [s * R.B] * (iters // s) + ([iters % s * R.B] if iters % s else [])


# --------------------------------------------------------------------------
# the world and the layout
# --------------------------------------------------------------------------

def test_ranks_import_neither_jax_nor_the_reference(world):
    assert world.size == 4 and len(set(world.pids)) == 4
    for packages in world.packages:
        assert "torch" in packages
        assert not {"jax", "jaxlib", "repro"} & set(packages), packages


@pytest.mark.parametrize("form", ["primal", "dual"])
@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_pad_shards_are_the_padded_operands(data, form, P):
    """Concatenated, the contiguous shards the ranks cut are X and y
    zero-padded to a multiple of P along the sharded axes, as the reference
    pads them."""
    X, y = data
    f = engine.FORMULATIONS[form]
    shards = [f.pad_shards(X, y, P, r) for r in range(P)]
    ax, ay = f.shard_axes
    Xp = torch.cat([xl for xl, _ in shards], dim=ax)
    pad = (-X.shape[ax]) % P
    want = np.pad(X.numpy(), [(0, pad) if a == ax else (0, 0)
                              for a in range(2)])
    assert np.array_equal(Xp.numpy(), want)
    assert all(xl.is_contiguous() for xl, _ in shards)
    if ay is None:
        assert all(yl is y for _, yl in shards)
    else:
        yp = torch.cat([yl for _, yl in shards])
        assert np.array_equal(yp.numpy(), np.pad(y.numpy(), (0, pad)))
    w, alpha = f.dist_finalize(torch.zeros(R.D + (pad if ax == 0 else 0)),
                               torch.zeros(R.N + (pad if ax == 1 else 0)),
                               R.D, R.N)
    assert (w.shape, alpha.shape) == ((R.D,), (R.N,))


def test_world_holds_one_shard_per_layout(world, data):
    """A solve on another X, on another rank count or on an X changed in
    place cuts the layout's shards anew in place of the old ones; every
    solve matches the port's local solve on its own X."""
    X, y = data
    idx = {f: torch.from_numpy(R.index(f, R.ITERS)) for f in ("primal",
                                                              "dual")}
    local = {"primal": T.ca_bcd, "dual": T.ca_bdcd}
    sharded = {"primal": T.ca_bcd_sharded, "dual": T.ca_bdcd_sharded}
    Xc = X.clone()

    def check(form, Xs, P):
        w, alpha = sharded[form](world.ranks(P), Xs, y, R.LAM, R.B, R.S,
                                 R.ITERS, idx=idx[form])
        want = local[form](Xs, y, R.LAM, R.B, R.S, R.ITERS, idx=idx[form])
        _close(w, want.w)
        _close(alpha, want.alpha)

    for form, Xs, P in (("primal", X, 4), ("primal", Xc, 4), ("dual", X, 3),
                        ("primal", Xc, 2)):
        check(form, Xs, P)
        assert len(world._held) <= 2
    Xc.mul_(2.0)
    check("primal", Xc, 2)
    assert set(world._held) == {0, 1}
    assert world._held[1][1] is Xc


def test_rank_groups_and_their_limits(world):
    assert world.ranks(3).size == 3
    with pytest.raises(ValueError, match="exceeds"):
        world.ranks(5)
    with pytest.raises(ValueError):
        world.ranks(0)


# --------------------------------------------------------------------------
# collective counts: the port counts its own calls
# --------------------------------------------------------------------------

@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("form", ["primal", "dual"])
def test_one_all_reduce_per_outer_step(world, form, P, fuse, guard):
    """Exactly H = ceil(iters / s) all-reduces and no hop, guarded or not,
    each of sb (sb + 1) words of packet and the health word's five."""
    _solve(world, form, P, fuse_packet=fuse, guard=guard)
    widths = _steps(R.ITERS, R.S)
    assert len(widths) == math.ceil(R.ITERS / R.S)
    for c in world.last["counters"]:
        assert (c["all_reduces"], c["hops"]) == (len(widths), 0)
        assert c["words"] == sum(sb * (sb + 1) + engine.HEALTH_WORDS
                                 for sb in widths)
        assert c["size"] == P and not c["staged"]


@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("form", ["primal", "dual"])
def test_ring_makes_two_p_minus_one_hops_per_step(world, form, P, guard):
    """The ring: no all-reduce and 2 (P - 1) hops an outer step, each
    moving a 1/P chunk of the packet."""
    _solve(world, form, P, wire="ring", guard=guard)
    widths = _steps(R.ITERS, R.S)
    assert engine.ring_hops([P]) == 2 * (P - 1)
    for c in world.last["counters"]:
        assert c["all_reduces"] == 0
        assert c["hops"] == engine.ring_hops([P]) * len(widths)
        assert c["hop_words"] == sum(
            2 * (P - 1) * -(-(sb * (sb + 1) + engine.HEALTH_WORDS) // P)
            for sb in widths)


@pytest.mark.parametrize("T_", [1, 3])
def test_batched_shares_one_all_reduce(world, data, T_):
    """H all-reduces for any T, of sb^2 + T sb words: the Gram part does
    not grow with T."""
    X, _ = data
    ys, lams = R.tenants()
    batch = T.TenantBatch(ys=torch.from_numpy(ys[:T_]), lams=lams[:T_])
    world.ranks(4).solve_batched("primal", T.SolverPlan(b=R.B, s=R.S), X,
                                 batch, R.ITERS,
                                 idx=torch.from_numpy(R.index("primal")))
    widths = _steps(R.ITERS, R.S)
    for c in world.last["counters"]:
        assert c["all_reduces"] == len(widths)
        assert c["words"] == sum(sb * sb + T_ * sb for sb in widths)


# --------------------------------------------------------------------------
# port against port, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["psum", "ring"])
@pytest.mark.parametrize("P", [1, 3, 4])
@pytest.mark.parametrize("form", R.FORMS)
def test_guarded_clean_equals_unguarded(world, form, P, wire):
    w0, a0 = _solve(world, form, P, wire=wire)
    counts = [c["all_reduces"] + c["hops"] for c in world.last["counters"]]
    w1, a1, m = _solve(world, form, P, wire=wire, guard=True)
    assert torch.equal(w0, w1) and torch.equal(a0, a1)
    assert [c["all_reduces"] + c["hops"]
            for c in world.last["counters"]] == counts
    assert m == {"guard_trips": 0, "guard_first_trip": -1,
                 "guard_first_reason": 0, "guard_max_jitter": 0.0}


@pytest.mark.parametrize("wire", ["psum", "ring"])
@pytest.mark.parametrize("P", [2, 4])
def test_accelerated_at_beta_0_equals_primal(world, P, wire):
    wp, ap = _solve(world, "primal", P, wire=wire)
    wa, aa = _solve(world, "accelerated", P, wire=wire, beta=0.0)
    assert torch.equal(wp, wa) and torch.equal(ap, aa)


@pytest.mark.parametrize("wire", ["psum", "ring"])
@pytest.mark.parametrize("P", [2, 4])
def test_proximal_at_lam1_0_equals_ridge(world, P, wire):
    wp, ap = _solve(world, "primal", P, wire=wire)
    wx, ax = _solve(world, "proximal", P, wire=wire, lam1=0.0)
    assert torch.equal(wp, wx) and torch.equal(ap, ax)


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("form", ["primal", "dual"])
def test_fused_and_unfused_packets(world, form, P):
    """Bit for bit where a sum of P partials rounds alike in any order
    (P <= 2); beyond, the two layouts put an entry at different offsets of
    the all-reduced buffer, which gloo sums in different orders."""
    wf, af = _solve(world, form, P, fuse_packet=True)
    wu, au = _solve(world, form, P, fuse_packet=False)
    if P <= 2:
        assert torch.equal(wf, wu) and torch.equal(af, au)
    else:
        _close(wu, wf, ORDER_TOL, ORDER_TOL)
        _close(au, af, ORDER_TOL, ORDER_TOL)


@pytest.mark.parametrize("wire", ["psum", "ring"])
@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("form", ["primal", "dual", "proximal"])
def test_batched_equals_single_solves(world, data, form, P, wire):
    """Each tenant equals its single sharded solve: bit for bit at P <= 2,
    within the two layouts' summation order beyond (module docstring)."""
    X, _ = data
    ys, lams = R.tenants()
    coeffs = {"lam1": [0.0, 1e-3, 3e-3]} if form == "proximal" else {}
    batch = T.TenantBatch(ys=torch.from_numpy(ys), lams=lams, coeffs=coeffs)
    plan = T.SolverPlan(b=R.B, s=R.S, wire=wire)
    idx = torch.from_numpy(R.index(form))
    got = world.ranks(P).solve_batched(form, plan, X, batch, R.ITERS, idx=idx)
    for t in range(R.T):
        f = (T.ProximalElasticNet(lam1=coeffs["lam1"][t])
             if form == "proximal" else form)
        w, alpha = world.ranks(P).solve(f, plan, X, batch.ys[t], lams[t],
                                        R.ITERS, idx=idx)
        if P <= 2:
            assert torch.equal(got.ws[t], w) and torch.equal(got.alphas[t],
                                                            alpha)
        else:
            _close(got.ws[t], w, ORDER_TOL, ORDER_TOL)
            _close(got.alphas[t], alpha, ORDER_TOL, ORDER_TOL)
    assert bool(got.active.all())


def test_replicated_iterate_is_the_same_bytes_on_every_rank(world):
    """The world compares the replicated half of every rank's carry byte
    for byte on every call (and raises when they differ)."""
    for form in ("primal", "dual"):
        for wire in ("psum", "ring"):
            _solve(world, form, 4, wire=wire)
            assert world.last["replicas_equal"] and world.last["ranks"] == 4


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def test_local_backend_refuses_the_ring(data):
    X, y = data
    idx = torch.from_numpy(R.index("primal"))
    with pytest.raises(ValueError, match="needs a distributed backend"):
        T.s_step_solve("primal", T.SolverPlan(b=R.B, s=R.S, wire="ring"), X,
                       y, R.LAM, R.ITERS, idx=idx)
    ys, lams = R.tenants()
    batch = T.TenantBatch(ys=torch.from_numpy(ys), lams=lams)
    with pytest.raises(ValueError, match="needs a distributed backend"):
        T.s_step_solve_batched("primal",
                               T.SolverPlan(b=R.B, s=R.S, wire="ring"), X,
                               batch, R.ITERS, idx=idx)
    with pytest.raises(ValueError, match="'psum' or 'ring'"):
        T.SolverPlan(b=2, wire="tree")


def test_batched_sharded_refuses_tol(world, data):
    X, _ = data
    ys, lams = R.tenants()
    batch = T.TenantBatch(ys=torch.from_numpy(ys), lams=lams, tol=1e-3)
    with pytest.raises(ValueError, match="TenantBatch.tol"):
        world.solve_batched("primal", T.SolverPlan(b=R.B, s=R.S), X, batch,
                            R.ITERS, idx=torch.from_numpy(R.index("primal")))


def test_nccl_beyond_the_card_count_raises():
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="one card per rank"):
        T.SolverWorld(cards + 1, backend="nccl", device="cuda")
    with pytest.raises(ValueError, match="CUDA devices only"):
        T.SolverWorld(1, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="'gloo' or 'nccl'"):
        T.SolverWorld(1, backend="mpi", device="cpu")


def test_a_cuda_world_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.SolverWorld(2)                      # the card is the default


def test_distributed_ridge_launcher_on_the_cpu():
    from repro_torch.launch import distributed_ridge
    out = distributed_ridge.main(device="cpu", ranks=2)
    assert max(out["errors"].values()) < 1e-10
    assert out["all_reduces"] == {1: 64, 8: 8}


# --------------------------------------------------------------------------
# the shard-balanced sampler
# --------------------------------------------------------------------------

@pytest.mark.parametrize("P", [1, 2, 4])
def test_balanced_sampler_properties(P):
    g = torch.Generator().manual_seed(3)
    idx = T.sample_blocks(g, 40, 8, 50, mode="shard_balanced", n_shards=P)
    assert idx.shape == (50, 8) and idx.dtype == torch.int32
    per, shard_len = 8 // P, 40 // P
    for row in idx.tolist():
        assert len(set(row)) == 8                    # no replacement
        for k in range(P):                           # b / P from each shard
            part = row[k * per:(k + 1) * per]
            assert all(k * shard_len <= i < (k + 1) * shard_len
                       for i in part)
    assert set(idx.flatten().tolist()) == set(range(40))
    again = T.sample_blocks_balanced(torch.Generator().manual_seed(3), 40, 8,
                                     50, P)
    assert torch.equal(idx, again)


def test_balanced_sampler_refusals():
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="b=6 must be divisible"):
        T.sample_blocks_balanced(g, 40, 6, 2, 4)
    with pytest.raises(ValueError, match="n_total=42 must be divisible"):
        T.sample_blocks_balanced(g, 42, 8, 2, 4)
    with pytest.raises(ValueError, match="only applies"):
        T.sample_blocks(g, 40, 8, 2, n_shards=4)


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("form", R.FORMS)
def test_sharded_matches_reference(world, ref, form, P):
    """Against the reference's sharded solve and, but for the accelerated
    formulation, its local one: a sharded step applies its s blocks in one
    deferred update, and the momentum reshapes that update, so at s > 1
    the reference's own sharded and local accelerated solves differ (its
    velocity takes the last of a repeated index's steps)."""
    w, alpha = _solve(world, form, P)
    wants = [ref[f"sh_{form}_P{P}"]]
    if form != "accelerated":
        wants.append(ref[f"loc_{form}"])
    for want in wants:
        _close(w, want["w"])
        _close(alpha, want["alpha"])


@pytest.mark.parametrize("form", ["primal", "dual"])
def test_classical_sharded_matches_reference(world, ref, form):
    w, alpha = _solve(world, form, 4, s=1, fuse_packet=False)
    _close(w, ref[f"sh_{form}_P4_s1"]["w"])
    _close(alpha, ref[f"sh_{form}_P4_s1"]["alpha"])


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("form", R.FORMS)
def test_ring_matches_reference_psum(world, ref, form, P):
    w, alpha = _solve(world, form, P, wire="ring")
    want = ref[f"sh_{form}_P{max(P, 2)}"]
    _close(w, want["w"], RING_RTOL, RING_ATOL)
    _close(alpha, want["alpha"], RING_RTOL, RING_ATOL)


@pytest.mark.parametrize("form", ["primal", "dual"])
def test_guarded_clean_matches_reference(world, ref, form):
    w, alpha, m = _solve(world, form, 4, guard=True)
    want = ref[f"guard_{form}_P4"]
    assert m == {k: want[k].item() for k in m}
    _close(w, want["w"])
    _close(alpha, want["alpha"])


@pytest.mark.parametrize("case", ["bat_primal_P3", "bat_dual_P4"])
def test_batched_sharded_matches_reference(world, ref, data, case):
    X, _ = data
    _, form, P = case.split("_")
    ys, lams = R.tenants()
    got = world.ranks(int(P[1])).solve_batched(
        form, T.SolverPlan(b=R.B, s=R.S), X,
        T.TenantBatch(ys=torch.from_numpy(ys), lams=lams), R.ITERS,
        idx=torch.from_numpy(R.index(form)))
    _close(got.ws, ref[case]["w"])
    _close(got.alphas, ref[case]["alpha"])
