"""The port on the card: each CUDA kernel against its plain version, and the
solves through the kernels.  Every test carries the ``cuda`` marker and skips
with a reason on a machine without a CUDA device (the kernels have no CPU
mode).  This file imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: kernel against plain version, relative Frobenius 1e-5 in f32 (the
split contraction sums in another order than cuBLAS), for each output and for
G's cross terms alone (entries of two different indices), and 1e-12 in f64;
CA(s) against classical through the kernels, relative 1e-10 in f64.  The
matvec kernels K5/K6 sum in the packet's residual order, so they are held to
K3/K1's r, to their own single-tenant launches and, in the batched engine,
to the single solves under ``torch.equal``: no tolerance.  So are the dense
kernels K7 / K8: K7 on a gathered panel equals K1 on the same indices, K7
on the gathered transposed panel X[:, flat]^T at K3's chunk equals K3, and
K8's G equals K7's.  Neither the matvecs' output nor the dense kernels' nor
K1's, K2's, K3's or K4's depends on their launch geometry (rows per block,
ring depth; tile edge, micro-tile, ring, tile order; columns a block and
load batch; lanes a row), also under ``torch.equal``.
The
baselines through the kernels: CholeskyQR and CG against the direct solve in
f64, relative 1e-9 (CholeskyQR squares the operand's condition; CG stops at
tol 1e-13).
"""
import itertools

import pytest
import torch

from repro_torch import core
from repro_torch.kernels import gram as gk
from repro_torch.kernels.gram import ref as tref

pytestmark = pytest.mark.cuda

KERNELS = {"rows_packet": (gk.gram_packet_sampled_rows,
                           tref.gram_packet_sampled_ref),
           "rows_apply": (gk.panel_apply_rows, tref.panel_apply_ref),
           "cols_packet": (gk.gram_packet_sampled_cols,
                           tref.gram_packet_sampled_cols_ref),
           "cols_apply": (gk.panel_apply_cols, tref.panel_apply_cols_ref),
           "cols_matvec": (gk.panel_matvec_cols, tref.panel_matvec_cols_ref),
           "rows_matvec": (gk.panel_matvec_rows, tref.panel_matvec_ref)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).double().norm() / b.double().norm())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("m", [1, 8, 77, 200])
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_matches_plain_version_on_card(cuda_device, kernel, m, dtype,
                                              tol):
    g = torch.Generator(device=cuda_device).manual_seed(m)
    d, n = 300, 2001
    X = torch.randn((d, n), generator=g, device=cuda_device, dtype=dtype)
    layout, kind = kernel.split("_")
    samples, K = (d, n) if layout == "rows" else (n, d)
    flat = torch.randint(0, samples, (m,), generator=g, device=cuda_device,
                         dtype=torch.int32)
    flat[-1] = flat[0]                                 # a duplicate index
    vec = torch.randn((m if kind == "apply" else K,), generator=g,
                      device=cuda_device, dtype=dtype)
    kern, plain = KERNELS[kernel]
    got, want = kern(X, flat, vec), plain(X, flat, vec)
    got = got if kind == "packet" else (got,)
    want = want if kind == "packet" else (want,)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel(a, b) <= tol
    if kind == "packet":
        assert torch.equal(got[0], got[0].T)         # mirrored exactly
        same = flat[:, None] == flat[None, :]
        if not bool(same.all()):
            assert _rel(got[0].masked_fill(same, 0.0),
                        want[0].masked_fill(same, 0.0)) <= tol



# bf16 packets (K1, K3, K7 on the tensor cores, f32 sums and outputs):
# within 1e-4 of the plain version in f64 on the upcast operand (G, r and
# G's cross terms), within the reference's bf16 tolerance 2e-2 of the bf16
# plain version, G == G^T, the same bits from two runs, and the identities
# of one code path: K1 == K7 on the gathered rows, K3 == K7 on X[:, flat]^T
# at K3's chunk (torch.equal).
TOL_BF16_F64 = 1e-4


def _bf16_gates(got, want64, want16, flat):
    G, r = got
    assert G.dtype == r.dtype == torch.float32
    assert _rel(G, want64[0]) <= TOL_BF16_F64
    assert _rel(r, want64[1]) <= TOL_BF16_F64
    same = flat[:, None] == flat[None, :]
    if not bool(same.all()):
        assert _rel(G.masked_fill(same, 0.0),
                    want64[0].masked_fill(same, 0.0)) <= TOL_BF16_F64
    assert _rel(G, want16[0]) <= 2e-2 and _rel(r, want16[1]) <= 2e-2
    assert torch.equal(G, G.T)


@pytest.mark.parametrize("m", [1, 8, 77, 200])
@pytest.mark.parametrize("K", [2001, 72309])
def test_bf16_packets_equal_f32_on_the_upcast_operand(cuda_device, m, K):
    """bf16 K1 and K7 (f32 sums and outputs, tensor cores) against the plain
    version in f64 on the upcast operand (1e-4, G, r and G's cross terms)
    and in bf16 (2e-2), G == G^T, two runs with the same bits, K1 == K7 on
    the gathered rows; each counts on its own bf16 counter."""
    g = torch.Generator(device=cuda_device).manual_seed(m)
    X = torch.randn((300, K), generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    u = torch.randn((K,), generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    flat = torch.randint(0, 300, (m,), generator=g, device=cuda_device,
                         dtype=torch.int32)
    flat[-1] = flat[0]
    knobs = {"scale": 0.5, "reg": 0.25, "scale_r": 2.0}
    gk.reset_launch_counts()
    G1, r1 = gk.gram_packet_sampled_rows(X, flat, u, **knobs)
    Y = X[flat.long()].contiguous()
    G7, r7 = gk.gram_packet_dense(Y, u, **knobs)
    assert gk.ROWS_PACKET_BF16.launches == gk.DENSE_PACKET_BF16.launches == 1
    assert gk.ROWS_PACKET.launches == gk.DENSE_PACKET.launches == 0
    want64 = tref.gram_packet_sampled_ref(X.double(), flat, u.double(),
                                          **knobs)
    want16 = tref.gram_packet_sampled_ref(X, flat, u, **knobs)
    _bf16_gates((G1, r1), want64, want16, flat)
    assert torch.equal(G1, G7) and torch.equal(r1, r7)
    again = gk.gram_packet_sampled_rows(X, flat, u, **knobs)
    assert torch.equal(again[0], G1) and torch.equal(again[1], r1)


@pytest.mark.parametrize("n", [5000, 5001])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 128, 200])
@pytest.mark.parametrize("d", [300, 20958])
def test_bf16_cols_packet_equals_f32_and_k7(cuda_device, m, d, n):
    """bf16 K3 (f32 sums and outputs, tensor cores) at both tile edges:
    against the plain version in f64 on the upcast operand (1e-4) and in
    bf16 (2e-2), G == G^T, two runs with the same bits, and equal to bf16
    K7 on X[:, flat]^T at K3's chunk under torch.equal; counted on its own
    counter.  An odd row length n puts the elements of one sampled column
    in alternate halves of their 4-byte words."""
    from repro_torch.kernels.gram import sampled_colmajor as sc
    g = torch.Generator(device=cuda_device).manual_seed(m + d)
    X = torch.randn((d, n), generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    u = torch.randn((d,), generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    flat = torch.randint(0, n, (m,), generator=g, device=cuda_device,
                         dtype=torch.int32)
    flat[-1] = flat[0]
    knobs = {"scale": 0.5, "reg": 0.25, "scale_r": 2.0}
    gk.reset_launch_counts()
    G3, r3 = gk.gram_packet_sampled_cols(X, flat, u, **knobs)
    assert gk.COLS_PACKET_BF16.launches == 1 and gk.COLS_PACKET.launches == 0
    want64 = tref.gram_packet_sampled_cols_ref(X.double(), flat, u.double(),
                                               **knobs)
    want16 = tref.gram_packet_sampled_cols_ref(X, flat, u, **knobs)
    _bf16_gates((G3, r3), want64, want16, flat)
    chunk = sc.cols_packet_geometry(m, d, torch.bfloat16).chunk
    Y = X[:, flat.long()].T.contiguous()
    G7, r7 = gk.gram_packet_dense(Y, u, bk=chunk, **knobs)
    assert torch.equal(G3, G7) and torch.equal(r3, r7)
    again = gk.gram_packet_sampled_cols(X, flat, u, **knobs)
    assert torch.equal(again[0], G3) and torch.equal(again[1], r3)


def test_kernel_refuses_bad_indices_on_card(cuda_device):
    X = torch.zeros((5, 7), device=cuda_device)
    flat = torch.tensor([0, 5], dtype=torch.int32, device=cuda_device)
    with pytest.raises(IndexError):
        gk.gram_packet_sampled_rows(X, flat, torch.zeros(7,
                                                         device=cuda_device))
    with pytest.raises(IndexError):
        gk.panel_apply_rows(X, flat, torch.zeros(2, device=cuda_device))
    cols = torch.tensor([0, 7], dtype=torch.int32, device=cuda_device)
    with pytest.raises(IndexError):
        gk.gram_packet_sampled_cols(X, cols, torch.zeros(5,
                                                         device=cuda_device))
    with pytest.raises(IndexError):
        gk.panel_apply_cols(X, cols, torch.zeros(2, device=cuda_device))
    with pytest.raises(TypeError, match="bf16"):
        gk.panel_apply_cols(X.to(torch.bfloat16), flat[:1],
                            torch.zeros(1, device=cuda_device,
                                        dtype=torch.bfloat16))


@pytest.mark.parametrize("form", ["primal", "dual"])
def test_solves_run_through_the_kernels_and_match_classical(cuda_device,
                                                            form):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    d, n, b, iters = 40, 90, 4, 23
    X = torch.randn((d, n), generator=g, device=cuda_device,
                    dtype=torch.float64)
    y = torch.randn((n,), generator=g, device=cuda_device,
                    dtype=torch.float64)
    solve = core.ca_bcd if form == "primal" else core.ca_bdcd
    idx = core.sample_blocks(g, d if form == "primal" else n, b, iters)
    gk.reset_launch_counts()
    base = solve(X, y, 0.1, b, 1, iters, idx=idx)
    ca = solve(X, y, 0.1, b, 5, iters, idx=idx)
    ref = solve(X, y, 0.1, b, 5, iters, idx=idx, impl="ref")
    packet, apply = ((gk.ROWS_PACKET, gk.ROWS_APPLY) if form == "primal"
                     else (gk.COLS_PACKET, gk.COLS_APPLY))
    assert packet.launches == iters + -(-iters // 5)
    assert apply.launches == 2 * iters
    assert _rel(ca.w, base.w) <= 1e-10 and _rel(ca.alpha, base.alpha) <= 1e-10
    assert _rel(ca.w, ref.w) <= 1e-10


def _layout_problem(device, dtype, layout, m, tenants, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    d, n = 300, 2001
    X = torch.randn((d, n), generator=g, device=device, dtype=dtype)
    samples, K = (d, n) if layout == "rows" else (n, d)
    flat = torch.randint(0, samples, (m,), generator=g, device=device,
                         dtype=torch.int32)
    flat[-1] = flat[0]
    t = torch.randn((tenants, K), generator=g, device=device, dtype=dtype)
    return X, flat, t


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 8, 77, 128, 200])
@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_matvec_equals_packet_residual_on_card(cuda_device, layout, m,
                                               dtype):
    X, flat, t = _layout_problem(cuda_device, dtype, layout, m, 1, m + 7)
    packet = (gk.gram_packet_sampled_rows if layout == "rows"
              else gk.gram_packet_sampled_cols)
    matvec = (gk.panel_matvec_rows if layout == "rows"
              else gk.panel_matvec_cols)
    _, r = packet(X, flat, t[0], scale=1.0, scale_r=1.0)
    assert torch.equal(matvec(X, flat, t[0]), r)


@pytest.mark.parametrize("tenants", [2, 33, 70])
@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_tenant_launch_equals_single_launches_on_card(cuda_device, layout,
                                                      tenants):
    X, flat, t = _layout_problem(cuda_device, torch.float32, layout, 77,
                                 tenants, tenants)
    matvec = (gk.panel_matvec_rows if layout == "rows"
              else gk.panel_matvec_cols)
    gk.reset_launch_counts()
    out = matvec(X, flat, t, scale=0.5)
    info = gk.ROWS_MATVEC if layout == "rows" else gk.COLS_MATVEC
    assert info.launches == 1 and out.shape == (tenants, 77)
    for j in range(tenants):
        assert torch.equal(out[j], matvec(X, flat, t[j], scale=0.5))


@pytest.mark.parametrize("form", ["primal", "dual", "proximal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_equals_singles_through_the_kernels(cuda_device, form,
                                                    dtype):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    d, n, b, s, iters, T = 60, 150, 4, 5, 23, 3
    X = torch.randn((d, n), generator=g, device=cuda_device, dtype=dtype)
    ys = torch.randn((T, n), generator=g, device=cuda_device, dtype=dtype)
    lams, lam1s = (0.05, 0.2, 1.0), (0.01, 0.02, 0.004)
    idx = core.sample_blocks(g, n if form == "dual" else d, b, iters)
    coeffs = {"lam1": lam1s} if form == "proximal" else {}
    plan = core.SolverPlan(b=b, s=s)
    gk.reset_launch_counts()
    res = core.s_step_solve_batched(
        form, plan, X, core.TenantBatch(ys=ys, lams=lams, coeffs=coeffs),
        iters, idx=idx)
    matvec = gk.COLS_MATVEC if form == "dual" else gk.ROWS_MATVEC
    assert matvec.launches == -(-iters // s)
    for t in range(T):
        f = (core.ProximalElasticNet(lam1=lam1s[t]) if form == "proximal"
             else form)
        single = core.s_step_solve(f, plan, X, ys[t], lams[t], iters,
                                   idx=idx)
        assert torch.equal(res.ws[t], single.w)
        assert torch.equal(res.alphas[t], single.alpha)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("m,K", [(1, 33), (8, 2001), (77, 300), (200, 2001)])
def test_dense_kernels_match_plain_versions_on_card(cuda_device, m, K, dtype,
                                                    tol):
    g = torch.Generator(device=cuda_device).manual_seed(m + K)
    A = torch.randn((m, K), generator=g, device=cuda_device, dtype=dtype)
    u = torch.randn((K,), generator=g, device=cuda_device, dtype=dtype)
    gk.reset_launch_counts()
    G, r = gk.gram_packet_dense(A, u, scale=0.5, reg=0.25, scale_r=2.0)
    G8 = gk.gram_dense(A, scale=0.5, reg=0.25)
    assert gk.DENSE_PACKET.launches == gk.DENSE_GRAM.launches == 1
    Gw, rw = tref.gram_packet_ref(A, u, 0.5, 0.25, 2.0)
    assert G.dtype == dtype and G.shape == (m, m) and r.shape == (m,)
    assert _rel(G, Gw) <= tol and _rel(r, rw) <= tol
    assert torch.equal(G, G.T)
    if m > 1:
        off = ~torch.eye(m, dtype=torch.bool, device=cuda_device)
        assert _rel(G[off], Gw[off]) <= tol
    assert torch.equal(G8, G)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 8, 77, 128, 200])
def test_dense_packet_on_gathered_panel_equals_sampled_packet_on_card(
        cuda_device, m, dtype):
    X, flat, t = _layout_problem(cuda_device, dtype, "rows", m, 1, m + 11)
    knobs = {"scale": 0.5, "reg": 0.25}
    G1, r1 = gk.gram_packet_sampled_rows(X, flat, t[0], scale_r=2.0, **knobs)
    Y = X[flat.long()].contiguous()
    G7, r7 = gk.gram_packet_dense(Y, t[0], scale_r=2.0, **knobs)
    assert torch.equal(G7, G1) and torch.equal(r7, r1)
    assert torch.equal(gk.gram_dense(Y, **knobs), G7)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("K", [301, 2000])
@pytest.mark.parametrize("m", [1, 77, 129, 300, 2900])
def test_dense_kernels_at_ragged_m_match_plain_versions_on_card(
        cuda_device, m, K, dtype, tol):
    """K7 and K8 past every tile edge (m = 2900 takes the 128-tiles), with
    rows of A 4-byte aligned (odd K) or 16-byte aligned (K = 2000), scale
    and reg: against their plain versions; K8 equals K7's G, G its
    transpose, and K7 equals K1 on the same rows (X = A, flat = arange)."""
    g = torch.Generator(device=cuda_device).manual_seed(3 * m + K)
    A = torch.randn((m, K), generator=g, device=cuda_device, dtype=dtype)
    u = torch.randn((K,), generator=g, device=cuda_device, dtype=dtype)
    knobs = {"scale": 0.5, "reg": 0.25}
    G, r = gk.gram_packet_dense(A, u, scale_r=2.0, **knobs)
    G8 = gk.gram_dense(A, **knobs)
    Gw, rw = tref.gram_packet_ref(A, u, 0.5, 0.25, 2.0)
    assert G.shape == (m, m) and r.shape == (m,) and G.dtype == dtype
    assert _rel(G, Gw) <= tol and _rel(r, rw) <= tol
    if m > 1:
        off = ~torch.eye(m, dtype=torch.bool, device=cuda_device)
        assert _rel(G[off], Gw[off]) <= tol
    assert torch.equal(G8, G) and torch.equal(G, G.T)
    flat = torch.arange(m, dtype=torch.int32, device=cuda_device)
    G1, r1 = gk.gram_packet_sampled_rows(A, flat, u, scale_r=2.0, **knobs)
    assert torch.equal(G, G1) and torch.equal(r, r1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,K", [(77, 301), (129, 2001), (2900, 301)])
def test_dense_geometry_changes_no_sum_on_card(cuda_device, m, K, dtype):
    """Every tile edge, micro-tile, ring depth, stage length and tile order
    the dense kernels are built for gives the pick's G and r bit for bit,
    at one split (the kernel writes G) and at several (partials and the
    reduce pass): only the chunk fixes a sum."""
    from repro_torch.kernels.gram import gram_kernel as gkk
    g = torch.Generator(device=cuda_device).manual_seed(m)
    A = torch.randn((m, K), generator=g, device=cuda_device, dtype=dtype)
    u = torch.randn((K,), generator=g, device=cuda_device, dtype=dtype)
    auto = gkk.dense_geometry(m, K, dtype)
    want7 = gkk.launch_dense(gk.DENSE_PACKET, A, u, auto, 0.5, 0.25, 2.0)
    want8, _ = gkk.launch_dense(gk.DENSE_GRAM, A, None, auto, 0.5, 0.25,
                                None)
    geoms = [gkk.dense_geometry(m, K, dtype, bm=bm, micro=(tm, tn),
                                stages=st, steps=q, group=grp)
             for (bm, tm, tn), (st, q), grp in itertools.product(
                 gkk.DENSE_TILES[dtype], gkk.DENSE_RINGS[dtype], (1, 16))]
    for geom in geoms:
        G, r = gkk.launch_dense(gk.DENSE_PACKET, A, u, geom, 0.5, 0.25, 2.0)
        assert torch.equal(G, want7[0]) and torch.equal(r, want7[1]), geom
        G8, _ = gkk.launch_dense(gk.DENSE_GRAM, A, None, geom, 0.5, 0.25,
                                 None)
        assert torch.equal(G8, want8), geom
    assert torch.equal(want8, want7[0])


def test_dense_kernel_refuses_a_geometry_it_is_not_built_for_on_card(
        cuda_device):
    """The C entry point checks the geometry the host asks for (and the
    shared memory it counted) before anything is launched."""
    from repro_torch.kernels.gram import gram_kernel as gkk
    A = torch.ones((40, 100), device=cuda_device)
    geom = gkk.dense_geometry(40, 100, A.dtype)
    for bad in (geom._replace(smem=geom.smem + 16), geom._replace(bm=48),
                geom._replace(stages=5)):
        with pytest.raises(RuntimeError, match="cudaError_t"):
            gkk.launch_dense(gk.DENSE_GRAM, A, None, bad, 1.0, 0.0, None)


def test_dense_kernels_refuse_a_non_contiguous_operand_on_card(cuda_device):
    A = torch.zeros((7, 5), device=cuda_device).T
    with pytest.raises(ValueError, match="contiguous"):
        gk.gram_dense(A)
    with pytest.raises(ValueError, match="contiguous"):
        gk.gram_packet_dense(A, torch.zeros(7, device=cuda_device))


@pytest.mark.parametrize("branch", ["primal", "dual"])
def test_baselines_run_through_the_kernels_on_card(cuda_device, branch):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    d, n = (40, 90) if branch == "primal" else (90, 40)
    X = torch.randn((d, n), generator=g, device=cuda_device,
                    dtype=torch.float64)
    y = torch.randn((n,), generator=g, device=cuda_device,
                    dtype=torch.float64)
    w_opt = core.ridge_exact(X, y, 0.1)
    gk.reset_launch_counts()
    w_chol = core.tsqr_ridge(X, y, 0.1, method="cholqr")
    assert gk.DENSE_GRAM.launches == 1
    assert _rel(w_chol, w_opt) <= 1e-9
    assert _rel(core.tsqr_ridge(X, y, 0.1), w_opt) <= 1e-9
    res = core.cg_ridge(X, y, 0.1, tol=1e-13, impl="cuda")
    assert gk.ROWS_APPLY.launches == gk.ROWS_MATVEC.launches == res.iters
    assert _rel(res.w, w_opt) <= 1e-9


def _matvec_pair(layout):
    if layout == "rows":
        return gk.gram_packet_sampled_rows, gk.panel_matvec_rows
    return gk.gram_packet_sampled_cols, gk.panel_matvec_cols


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,chunk", [(77, "shortest"), (77, "ragged"),
                                     (33, "whole"), (1000, "whole")])
@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_matvec_equals_packet_residual_at_explicit_chunk_on_card(
        cuda_device, layout, m, chunk, dtype):
    """At an explicit chunk: the shortest (32 steps), one that leaves a
    ragged last split (n = 2001 = 20 * 96 + 81, d = 300 = 4 * 64 + 44), and
    one split over the whole contraction (the longest chains)."""
    X, flat, t = _layout_problem(cuda_device, dtype, layout, m, 1, m + 13)
    K = t.shape[1]
    bk = {"shortest": 32, "ragged": 96 if layout == "rows" else 64,
          "whole": -(-K // 32) * 32}[chunk]
    packet, matvec = _matvec_pair(layout)
    _, r = packet(X, flat, t[0], scale=1.0, scale_r=1.0, bk=bk)
    assert torch.equal(matvec(X, flat, t[0], bk=bk), r)


@pytest.mark.parametrize("tenants", [3, 40])
@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_tenant_launch_equals_single_launches_f64_on_card(cuda_device,
                                                          layout, tenants):
    X, flat, t = _layout_problem(cuda_device, torch.float64, layout, 77,
                                 tenants, tenants + 1)
    _, matvec = _matvec_pair(layout)
    out = matvec(X, flat, t, scale=0.25)
    assert out.shape == (tenants, 77) and out.dtype == torch.float64
    for j in range(tenants):
        assert torch.equal(out[j], matvec(X, flat, t[j], scale=0.25))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_rows_matvec_at_cg_shape_matches_plain_version_on_card(cuda_device,
                                                                dtype, tol):
    """K6 with flat = arange(d), CG's X p, against its plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    d, n = 300, 2001
    X = torch.randn((d, n), generator=g, device=cuda_device, dtype=dtype)
    flat = torch.arange(d, dtype=torch.int32, device=cuda_device)
    p = torch.randn((n,), generator=g, device=cuda_device, dtype=dtype)
    got = gk.panel_matvec_rows(X, flat, p)
    assert got.shape == (d,)
    assert _rel(got, tref.panel_matvec_ref(X, flat, p)) <= tol


@pytest.mark.parametrize("tenants", [1, 8])
@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_matvec_geometry_changes_no_sum_on_card(cuda_device, layout,
                                                tenants):
    """Every rows-per-block, ring depth and stage length the kernel is built
    for gives the default geometry's output bit for bit: only the chunk
    fixes a sum."""
    from repro_torch.kernels.gram import sampled_colmajor as sc
    from repro_torch.kernels.gram import sampled_kernel as sk
    X, flat, t = _layout_problem(cuda_device, torch.float32, layout, 77,
                                 tenants, 9)
    d, n = X.shape
    K = t.shape[1]
    info, symbol, args, sizes = (
        (sk.ROWS_MATVEC, "rows_matvec", sk.MATVEC_ARGS, (n,))
        if layout == "rows" else
        (sc.COLS_MATVEC, "cols_matvec", sc.MATVEC_ARGS, (d, n)))
    want = _matvec_pair(layout)[1](X, flat, t)
    for rows, stages, steps in itertools.product(sk.MV_ROWS, sk.MV_STAGES,
                                                 sk.MV_STEPS):
        geom = sk.matvec_geometry(77, K, tenants, X.dtype, layout, rows=rows,
                                  stages=stages, steps=steps)
        got = sk.launch_matvec(info, symbol, args, X, flat, t, sizes, geom,
                               1.0)
        assert torch.equal(got, want), (rows, stages, steps)


def _rows_problem(device, dtype, d, n, m, seed):
    """X (d, n), m indices with duplicates (one forced), u (n,), v (m,)."""
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((d, n), generator=g, device=device, dtype=dtype)
    flat = torch.randint(0, d, (m,), generator=g, device=device,
                         dtype=torch.int32)
    flat[-1] = flat[0]
    u = torch.randn((n,), generator=g, device=device, dtype=dtype)
    v = torch.randn((m,), generator=g, device=device, dtype=dtype)
    return X, flat, u, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2001, 2000])
@pytest.mark.parametrize("m", [1, 8, 77, 129, 300])
def test_row_packet_equals_dense_packet_on_gathered_rows_on_card(
        cuda_device, m, n, dtype):
    """K1 on (X, flat) equals K7 on the gathered panel X[flat] and K6
    equals K1's r, under torch.equal, at ragged m with duplicate indices,
    rows of X 4-byte (odd n) or 16-byte aligned (even n), scale and reg."""
    X, flat, u, _ = _rows_problem(cuda_device, dtype, 300, n, m, m + n)
    knobs = {"scale": 0.5, "reg": 0.25}
    gk.reset_launch_counts()
    G1, r1 = gk.gram_packet_sampled_rows(X, flat, u, scale_r=2.0, **knobs)
    assert gk.ROWS_PACKET.launches == 1
    G7, r7 = gk.gram_packet_dense(X[flat.long()].contiguous(), u,
                                  scale_r=2.0, **knobs)
    assert torch.equal(G1, G7) and torch.equal(r1, r7)
    assert torch.equal(G1, G1.T)
    _, r = gk.gram_packet_sampled_rows(X, flat, u, scale=1.0, scale_r=1.0)
    assert torch.equal(gk.panel_matvec_rows(X, flat, u), r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,bk", [(77, 2001, None), (129, 2001, None),
                                    (300, 2001, 2016), (2900, 301, None)])
def test_row_packet_geometry_changes_no_sum_on_card(cuda_device, m, n, bk,
                                                    dtype):
    """Every geometry K1's gathered tile is built for gives the pick's G and
    r bit for bit, at several splits and at one (bk = 2016 >= n; m = 2900
    picks one split itself)."""
    from repro_torch.kernels.gram import gram_kernel as gkk
    from repro_torch.kernels.gram import sampled_kernel as sk
    X, flat, u, _ = _rows_problem(cuda_device, dtype, 300, n, m, m)
    auto = sk.rows_packet_geometry(m, n, dtype, bk)
    want = gk.gram_packet_sampled_rows(X, flat, u, scale=0.5, reg=0.25,
                                       scale_r=2.0, bk=bk)
    for bm, tm, tn in gkk.GATHERED_TILES[dtype]:
        geom = sk.rows_packet_geometry(m, n, dtype, bk, bm=bm,
                                       micro=(tm, tn))
        assert geom.chunk == auto.chunk
        G, r = gkk.launch_dense(gk.ROWS_PACKET, X, u, geom, 0.5, 0.25, 2.0,
                                flat)
        assert torch.equal(G, want[0]) and torch.equal(r, want[1]), geom


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("m", [8, 77, 2900, "cg"])
def test_row_apply_matches_plain_version_on_card(cuda_device, m, dtype,
                                                 tol):
    """K2 against its plain version at the solve's m = 8, ragged m, a long
    chain with duplicates (m = 2900 > d) and CG's shape (flat = arange(d)),
    with every geometry it is built for giving the pick's output bit for
    bit."""
    from repro_torch.kernels.gram import sampled_kernel as sk
    d, n = (2900, 2001) if m == "cg" else (300, 2001)
    X, flat, _, v = _rows_problem(cuda_device, dtype, d, n,
                                  d if m == "cg" else m, 17)
    if m == "cg":
        flat = torch.arange(d, dtype=torch.int32, device=cuda_device)
    gk.reset_launch_counts()
    got = gk.panel_apply_rows(X, flat, v, scale=0.5)
    assert gk.ROWS_APPLY.launches == 1
    want = tref.panel_apply_ref(X, flat, v, 0.5)
    assert got.dtype == dtype and got.shape == (n,)
    assert _rel(got, want) <= tol
    for threads in sk.APPLY_THREADS:
        for cols, batch in sk.APPLY_BUILT[dtype]:
            geom = sk.apply_geometry(flat.shape[0], n, dtype,
                                     threads=threads, cols=cols, batch=batch)
            assert torch.equal(sk.launch_apply(X, flat, v, geom, 0.5),
                               got), geom


def _cols_problem(device, dtype, d, n, m, seed):
    """X (d, n), m column indices with duplicates (one forced), u (d,),
    v (m,)."""
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((d, n), generator=g, device=device, dtype=dtype)
    flat = torch.randint(0, n, (m,), generator=g, device=device,
                         dtype=torch.int32)
    flat[-1] = flat[0]
    u = torch.randn((d,), generator=g, device=device, dtype=dtype)
    v = torch.randn((m,), generator=g, device=device, dtype=dtype)
    return X, flat, u, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [2001, 2000])
@pytest.mark.parametrize("m", [1, 8, 77, 129, 300])
def test_col_packet_equals_dense_packet_on_gathered_columns_on_card(
        cuda_device, m, d, dtype):
    """K3 on (X, flat) equals K7 on the gathered transposed panel
    X[:, flat]^T at K3's chunk, and K5 equals K3's r, under torch.equal, at
    ragged m with duplicate indices, odd and even d, scale and reg."""
    from repro_torch.kernels.gram import sampled_colmajor as sc
    X, flat, u, _ = _cols_problem(cuda_device, dtype, d, 301, m, m + d)
    knobs = {"scale": 0.5, "reg": 0.25}
    gk.reset_launch_counts()
    G3, r3 = gk.gram_packet_sampled_cols(X, flat, u, scale_r=2.0, **knobs)
    assert gk.COLS_PACKET.launches == 1
    chunk = sc.cols_packet_geometry(m, d, dtype).chunk
    G7, r7 = gk.gram_packet_dense(X[:, flat.long()].T.contiguous(), u,
                                  scale_r=2.0, bk=chunk, **knobs)
    assert torch.equal(G3, G7) and torch.equal(r3, r7)
    assert torch.equal(G3, G3.T)
    _, r = gk.gram_packet_sampled_cols(X, flat, u, scale=1.0, scale_r=1.0)
    assert torch.equal(gk.panel_matvec_cols(X, flat, u), r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,d,bk", [(8, 2001, None), (77, 2001, None),
                                    (129, 2001, None), (300, 301, 320)])
def test_col_packet_geometry_changes_no_sum_on_card(cuda_device, m, d, bk,
                                                    dtype):
    """Every geometry K3's gathered-column tile is built for gives the
    pick's G and r bit for bit, at several splits and at one (bk = 320 >=
    d)."""
    from repro_torch.kernels.gram import gram_kernel as gkk
    from repro_torch.kernels.gram import sampled_colmajor as sc
    X, flat, u, _ = _cols_problem(cuda_device, dtype, d, 1999, m, m)
    auto = sc.cols_packet_geometry(m, d, dtype, bk)
    want = gk.gram_packet_sampled_cols(X, flat, u, scale=0.5, reg=0.25,
                                       scale_r=2.0, bk=bk)
    for bm, tm, tn, st, q in gkk.COLS_BUILT[dtype]:
        geom = sc.cols_packet_geometry(m, d, dtype, bk, bm=bm, micro=(tm, tn),
                                       stages=st, steps=q)
        assert geom.chunk == auto.chunk
        G, r = gkk.launch_dense(gk.COLS_PACKET, X, u, geom, 0.5, 0.25, 2.0,
                                flat)
        assert torch.equal(G, want[0]) and torch.equal(r, want[1]), geom


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("m", [1, 8, 77, 128, 300])
def test_col_apply_matches_plain_version_on_card(cuda_device, m, dtype, tol):
    """K4 against its plain version at m = 1, the solve's m = 8, ragged m,
    m = 128 and two windows of samples (m = 300), with duplicates, and every
    segment width (>= min(m, 32)) it is built for giving the pick's output
    bit for bit."""
    from repro_torch.kernels.gram import sampled_colmajor as sc
    X, flat, _, v = _cols_problem(cuda_device, dtype, 1001, 2001, m, 19 + m)
    gk.reset_launch_counts()
    got = gk.panel_apply_cols(X, flat, v, scale=0.5)
    assert gk.COLS_APPLY.launches == 1
    want = tref.panel_apply_cols_ref(X, flat, v, 0.5)
    assert got.dtype == dtype and got.shape == (1001,)
    assert _rel(got, want) <= tol
    for seg in sc.APPLY_COLS_SEGS:
        if seg < min(m, 32):
            continue
        geom = sc.apply_cols_geometry(m, 1001, dtype, seg=seg)
        assert torch.equal(sc.launch_apply_cols(X, flat, v, geom, 0.5),
                           got), geom


def test_col_apply_refuses_a_geometry_it_is_not_built_for_on_card(
        cuda_device):
    """The C entry point refuses a segment too narrow for m, and a block
    size or segment width it is not built for, before a launch."""
    from repro_torch.kernels.gram import sampled_colmajor as sc
    X, flat, _, v = _cols_problem(cuda_device, torch.float32, 50, 70, 8, 3)
    geom = sc.apply_cols_geometry(8, 50, X.dtype)
    for bad in (geom._replace(seg=4), geom._replace(seg=64),
                geom._replace(seg=12), geom._replace(threads=128)):
        with pytest.raises(RuntimeError, match="cudaError_t"):
            sc.launch_apply_cols(X, flat, v, bad, 1.0)
