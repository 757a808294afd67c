"""The port's kernel layer against the reference's jnp oracles.

Inputs are made with numpy from a seed and handed to both packages.  The
plain versions (``repro_torch.kernels.gram.ref``) and the operand / ops
dispatch are checked against ``repro.kernels.gram.ref`` in f32 and f64, with
duplicate indices, shapes that are no multiple of any tile, and non-default
scale / reg / scale_r.  Tolerances: f64 rtol 1e-10 / atol 1e-12 (XLA and
ATen sum in different orders); f32 rtol 1e-5 / atol 1e-5 (sums of at most
~60 terms of unit size).  The plain matvecs are also held to the port's own
packet r under ``torch.equal``: they are written as its exact expression.

The CUDA kernels themselves run only on the card: their tests are in
``test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.gram import ColMajorOperand as JCols
from repro.kernels.gram import gram_packet_sampled as j_packet
from repro.kernels.gram import panel_apply as j_apply
from repro.kernels.gram import panel_matvec as j_matvec
from repro.kernels.gram import ref as jref
from repro_torch.kernels import gram as gk
from repro_torch.kernels.gram import ref as tref
from repro_torch.kernels.gram import tuning
from repro_torch.kernels.gram import sampled_colmajor as sc
from repro_torch.kernels.gram import sampled_kernel as sk
from repro_torch.kernels.gram.sampled_kernel import (check_cuda_operands,
                                                     resolve_chunk)

from _x64 import x64_mode  # noqa: F401  (autouse fixture)

DTYPES = {"f32": (np.float32, torch.float32, 1e-5, 1e-5),
          "f64": (np.float64, torch.float64, 1e-10, 1e-12)}
# (d, n, m): tile-aligned, ragged, and m larger than either tile edge
SHAPES = [(24, 40, 8), (37, 53, 11), (19, 70, 45)]
KNOBS = [(1.0, 0.0, None), (0.25, 0.5, 2.0)]


def _inputs(d, n, m, npdt, samples, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((d, n)).astype(npdt)
    flat = rng.integers(0, samples, size=m).astype(np.int32)
    flat[-1] = flat[0]                                # a duplicate index
    return X, flat, rng


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("knobs", KNOBS)
@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_packet_oracles_match_reference(dt, shape, knobs, layout):
    npdt, tdt, rtol, atol = DTYPES[dt]
    d, n, m = shape
    samples, K = (d, n) if layout == "rows" else (n, d)
    X, flat, rng = _inputs(d, n, m, npdt, samples)
    u = rng.standard_normal(K).astype(npdt)
    scale, reg, scale_r = knobs
    jfn = (jref.gram_packet_sampled_ref if layout == "rows"
           else jref.gram_packet_sampled_cols_ref)
    tfn = (tref.gram_packet_sampled_ref if layout == "rows"
           else tref.gram_packet_sampled_cols_ref)
    Gj, rj = jfn(jnp.asarray(X), jnp.asarray(flat), jnp.asarray(u), scale,
                 reg, scale_r)
    Gt, rt = tfn(torch.from_numpy(X), torch.from_numpy(flat),
                 torch.from_numpy(u), scale, reg, scale_r)
    assert Gt.dtype == tdt and Gt.shape == (m, m) and rt.shape == (m,)
    _close(Gt, Gj, rtol, atol)
    _close(rt, rj, rtol, atol)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_apply_oracles_match_reference(dt, shape, layout):
    npdt, tdt, rtol, atol = DTYPES[dt]
    d, n, m = shape
    samples = d if layout == "rows" else n
    X, flat, rng = _inputs(d, n, m, npdt, samples, seed=1)
    v = rng.standard_normal(m).astype(npdt)
    jfn = jref.panel_apply_ref if layout == "rows" else jref.panel_apply_cols_ref
    tfn = tref.panel_apply_ref if layout == "rows" else tref.panel_apply_cols_ref
    want = jfn(jnp.asarray(X), jnp.asarray(flat), jnp.asarray(v), 0.5)
    got = tfn(torch.from_numpy(X), torch.from_numpy(flat),
              torch.from_numpy(v), 0.5)
    assert got.dtype == tdt
    _close(got, want, rtol, atol)


def test_gram_and_packet_oracles_match_reference():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((13, 29))
    u = rng.standard_normal(29)
    _close(tref.gram_ref(torch.from_numpy(A), 0.5, 0.25),
           jref.gram_ref(jnp.asarray(A), 0.5, 0.25), 1e-10, 1e-12)
    G, r = tref.gram_packet_ref(torch.from_numpy(A), torch.from_numpy(u),
                                2.0, 1.0, 3.0)
    Gj, rj = jref.gram_packet_ref(jnp.asarray(A), jnp.asarray(u), 2.0, 1.0,
                                  3.0)
    _close(G, Gj, 1e-10, 1e-12)
    _close(r, rj, 1e-10, 1e-12)


def test_bf16_input_accumulates_in_f32():
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.standard_normal((9, 33)).astype(np.float32))
    Xb = X.to(torch.bfloat16)
    flat = torch.tensor([0, 4, 4, 8], dtype=torch.int32)
    G, r = tref.gram_packet_sampled_ref(Xb, flat, Xb[0])
    assert G.dtype == torch.float32 and r.dtype == torch.float32
    Y = Xb[flat.long()].float()
    torch.testing.assert_close(G, Y @ Y.T, rtol=0, atol=0)


@pytest.mark.parametrize("dt", DTYPES)
def test_operands_through_ops_match_reference(dt):
    """The port's ops dispatch (impl resolved from the CPU device) against
    the reference's ops with impl='ref', for both operand layouts."""
    npdt, _, rtol, atol = DTYPES[dt]
    d, n, m = 21, 34, 10
    rng = np.random.default_rng(4)
    X = rng.standard_normal((d, n)).astype(npdt)
    Xt = torch.from_numpy(X)
    for op_t, op_j, samples, K in (
            (gk.RowMajorOperand(Xt), jnp.asarray(X), d, n),
            (gk.ColMajorOperand(Xt), JCols(jnp.asarray(X)), n, d)):
        flat = rng.integers(0, samples, m).astype(np.int32)
        flat[3] = flat[1]
        u = rng.standard_normal(K).astype(npdt)
        v = rng.standard_normal(m).astype(npdt)
        G, r = gk.gram_packet_sampled(op_t, torch.from_numpy(flat),
                                      torch.from_numpy(u), scale=0.5,
                                      reg=0.25, scale_r=1.0)
        Gj, rj = j_packet(op_j, jnp.asarray(flat), jnp.asarray(u), scale=0.5,
                          reg=0.25, scale_r=1.0, impl="ref")
        _close(G, Gj, rtol, atol)
        _close(r, rj, rtol, atol)
        out = gk.panel_apply(op_t, torch.from_numpy(flat),
                             torch.from_numpy(v), scale=2.0)
        want = j_apply(op_j, jnp.asarray(flat), jnp.asarray(v), scale=2.0,
                       impl="ref")
        _close(out, want, rtol, atol)


def test_raw_tensor_means_row_major():
    X = torch.zeros((3, 5))
    assert isinstance(gk.as_operand(X), gk.RowMajorOperand)
    op = gk.ColMajorOperand(X)
    assert gk.as_operand(op) is op
    assert (op.samples, op.contraction) == (5, 3)


def test_wrappers_on_cpu_run_plain_versions_without_launching():
    rng = np.random.default_rng(5)
    X = torch.from_numpy(rng.standard_normal((11, 17)))
    flat = torch.tensor([1, 3, 3, 10], dtype=torch.int32)
    gk.reset_launch_counts()
    G, r = gk.gram_packet_sampled_rows(X, flat, X[0])
    torch.testing.assert_close(
        G, tref.gram_packet_sampled_ref(X, flat, X[0])[0], rtol=0, atol=0)
    out = gk.panel_apply_cols(X, flat, X[0, :4])
    torch.testing.assert_close(
        out, tref.panel_apply_cols_ref(X, flat, X[0, :4]), rtol=0, atol=0)
    G3, r3 = gk.gram_packet_sampled_cols(X, flat, X[:, 0], scale=0.5,
                                         reg=0.25, scale_r=2.0)
    W3, w3 = tref.gram_packet_sampled_cols_ref(X, flat, X[:, 0], 0.5, 0.25,
                                               2.0)
    torch.testing.assert_close(G3, W3, rtol=0, atol=0)
    torch.testing.assert_close(r3, w3, rtol=0, atol=0)
    torch.testing.assert_close(
        gk.panel_apply_rows(X, flat, X[0, :4]),
        tref.panel_apply_ref(X, flat, X[0, :4]), rtol=0, atol=0)
    torch.testing.assert_close(
        gk.panel_matvec_rows(X, flat, X[:2]),
        tref.panel_matvec_ref(X, flat, X[:2]), rtol=0, atol=0)
    torch.testing.assert_close(
        gk.panel_matvec_cols(X, flat, X[:, :2].T.contiguous()),
        tref.panel_matvec_cols_ref(X, flat, X[:, :2].T.contiguous()),
        rtol=0, atol=0)
    gk.gram_packet_dense(X, X[0])
    gk.gram_dense(X)
    assert len(gk.KERNELS) == 8
    assert [k.launches for k in gk.KERNELS] == [0] * len(gk.KERNELS)


@pytest.mark.parametrize("call", ["packet", "apply", "matvec"])
def test_impl_cuda_on_cpu_tensor_raises(call):
    X = torch.zeros((4, 6))
    flat = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        if call == "packet":
            gk.gram_packet_sampled(X, flat, torch.zeros(6), impl="cuda")
        elif call == "apply":
            gk.panel_apply(X, flat, torch.zeros(2), impl="cuda")
        else:
            gk.panel_matvec(X, flat, torch.zeros(6),
                            plan=gk.PacketPlan(impl="cuda"))


def test_packet_plan_validation():
    with pytest.raises(ValueError, match="unknown gram impl"):
        gk.PacketPlan(impl="pallas")
    for bad in (0, -32, 1.5, True, (32, 64)):
        with pytest.raises(ValueError, match="positive int"):
            gk.PacketPlan(bk=bad)
    with pytest.raises(TypeError):
        gk.PacketPlan(bm=32)            # the G tile edge is not a knob
    assert gk.PacketPlan("ref", 64) == gk.PacketPlan(impl="ref", bk=64)
    X = torch.zeros((4, 6))
    flat = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="positive int"):
        gk.gram_packet_sampled(X, flat, torch.zeros(6), bk=0)


def test_explicit_knobs_win_over_plan():
    X = torch.ones((4, 6))
    flat = torch.tensor([0, 1], dtype=torch.int32)
    cuda_plan = gk.PacketPlan(impl="cuda")
    G, _ = gk.gram_packet_sampled(X, flat, torch.ones(6), impl="ref",
                                  plan=cuda_plan)
    assert torch.equal(G, torch.full((2, 2), 6.0))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        gk.gram_packet_sampled(X, flat, torch.ones(6), plan=cuda_plan)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        gk.panel_apply(X, flat, torch.ones(2), impl="cuda",
                       plan=gk.PacketPlan(impl="ref"))


@pytest.mark.parametrize("m,K", [(8, 72309), (128, 72309), (128, 20958),
                                 (77, 100), (1, 1), (4096, 10**6)])
@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_pick_tiles_fill_the_card_within_limits(m, K, layout):
    bk = tuning.pick_tiles(m, K, torch.float32, layout)
    assert bk % tuning.BK == 0 and bk >= tuning.BK
    splits = -(-K // bk)
    assert 1 <= splits <= tuning.MAX_SPLITS
    blocks = tuning.lower_tiles(m) * splits
    # the layout's block target, wherever the contraction is long enough
    # (chunks round up to whole shared-memory steps, hence the 0.8)
    room = tuning.lower_tiles(m) * max(1, K // (tuning.BK * tuning.MIN_STEPS))
    assert blocks >= 0.8 * min(tuning.TARGET_BLOCKS[layout], room)
    assert resolve_chunk(m, K, torch.float32, layout, None) == bk


def test_pick_tiles_rejects_unknown_layout_and_bad_tiles():
    with pytest.raises(ValueError, match="layout"):
        tuning.pick_tiles(8, 100, torch.float32, "diag")
    with pytest.raises(ValueError, match="multiple of 32"):
        resolve_chunk(8, 100, torch.float32, "rows", 16)
    with pytest.raises(ValueError, match="multiple of 32"):
        resolve_chunk(8, 100, torch.float32, "rows", 48)
    assert resolve_chunk(8, 100, torch.float32, "rows", 64) == 64


@pytest.mark.parametrize("m,K,tenants", [
    (128, 72309, 1), (128, 72309, 8), (8, 72309, 8), (128, 20958, 32),
    (20958, 72309, 1), (77, 300, 70), (1, 1, 1), (4096, 10**6, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_matvec_geometry_within_limits_at_the_packets_chunk(m, K, tenants,
                                                             dtype, layout):
    """The launch geometry of K5 / K6: the packet's chunk (which fixes every
    sum), a grid within CUDA's limits that covers every (row, tenant, chunk),
    and shared memory within the block's 227 KB, at the pick and at every
    rows / stages / steps the kernel is built for (those that would need
    more shared memory are refused)."""
    chunk = resolve_chunk(m, K, dtype, layout, None)
    geoms = [sk.matvec_geometry(m, K, tenants, dtype, layout)]
    for r in sk.MV_ROWS:
        for s in sk.MV_STAGES:
            for q in sk.MV_STEPS:
                try:
                    geoms.append(sk.matvec_geometry(
                        m, K, tenants, dtype, layout, rows=r, stages=s,
                        steps=q))
                except ValueError as err:
                    assert "shared memory" in str(err)
    isz = 8 if dtype == torch.float64 else 4
    for geom in geoms:
        assert geom.chunk == chunk and geom.splits == -(-K // chunk)
        assert geom.grid[1] == geom.splits <= tuning.MAX_SPLITS
        assert tuning.TILE % geom.rows == 0
        assert 1 <= geom.group <= tenants
        assert geom.rows * geom.group <= geom.threads == sk.MV_THREADS
        row_groups = -(-m // geom.rows)
        assert geom.grid[0] == row_groups * -(-tenants // geom.group)
        assert geom.grid[0] < 2**31
        assert geom.smem <= sk.SMEM_PER_BLOCK
        assert geom.smem >= geom.stages * (geom.rows + geom.group) * (
            geom.steps + 16 // isz) * isz
    assert sk.matvec_geometry(m, K, tenants, dtype, layout, 64).chunk == 64


@pytest.mark.parametrize("m,n", [(8, 72309), (20958, 72309), (1, 1),
                                 (77, 2001), (16, 33), (9, 31),
                                 (300, 2**31 - 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_apply_geometry_within_limits(m, n, dtype):
    """The launch geometry of K2, the pick and every override it is built
    for: whole warps a block, within a block's 1024 threads and the grid's
    2**31 - 1 blocks, every column owned by one thread; a batch divides the
    32-sample window, and the pick's is the smallest built one that covers
    min(m, picked batch), else the largest built."""
    built = sk.APPLY_BUILT[dtype]
    auto = sk.apply_geometry(m, n, dtype)
    assert auto.cols == sk.APPLY_PICK[1]
    assert auto.threads == (sk.APPLY_WINDOW_THREADS if m <= 32
                            else sk.APPLY_PICK[0])
    qs = sorted(q for c, q in built if c == auto.cols)
    covering = [q for q in qs if q >= min(m, sk.APPLY_PICK[2])]
    assert auto.batch == (covering[0] if covering else qs[-1])
    assert auto.batch <= max(sk.APPLY_PICK[2], 8)
    geoms = [auto] + [sk.apply_geometry(m, n, dtype, threads=t, cols=c,
                                        batch=q)
                      for t in sk.APPLY_THREADS for c, q in built]
    for geom in geoms:
        assert geom.threads % 32 == 0 and geom.threads <= 256
        assert 32 % geom.batch == 0 and (geom.cols, geom.batch) in built
        span = geom.threads * geom.cols
        assert geom.blocks == -(-n // span) < 2**31
        assert (geom.blocks - 1) * span < n <= geom.blocks * span


@pytest.mark.parametrize("over,err", [
    ({"threads": 96}, ValueError), ({"threads": 512}, ValueError),
    ({"batch": 12}, ValueError), ({"batch": 64}, ValueError),
    ({"cols": 3}, ValueError), ({"cols": 8, "batch": 8}, ValueError),
    ({"dtype": torch.float64, "cols": 8, "batch": 4}, ValueError),
    ({"n": 2**31}, ValueError), ({"n": 0}, ValueError),
    ({"dtype": torch.bfloat16}, TypeError)])
def test_apply_geometry_refuses_what_the_kernel_is_not_built_for(over, err):
    args = {"m": 8, "n": 1000, "dtype": torch.float32} | over
    m, n, dtype = args.pop("m"), args.pop("n"), args.pop("dtype")
    with pytest.raises(err):
        sk.apply_geometry(m, n, dtype, **args)


def test_apply_host_table_matches_what_the_source_builds():
    """sampled_rows.cu's K2 dispatch lists the (cols, batch) pairs the host
    may ask for, per dtype."""
    import re
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1]
           / "src/repro_torch/csrc/sampled_rows.cu").read_text()
    body = src[src.index("int apply_impl("):src.index("#undef REPRO_APPLY")]
    f32, f64 = body.split("} else {")
    for dtype, part in ((torch.float32, f32), (torch.float64, f64)):
        built = {tuple(map(int, t)) for t in
                 re.findall(r"REPRO_APPLY\((\d+), (\d+)\)\n", part)}
        assert built == set(sk.APPLY_BUILT[dtype])
    assert set(map(int, re.findall(r"threads != (\d+)", body))) == set(
        sk.APPLY_THREADS)


@pytest.mark.parametrize("m,d", [(8, 20958), (128, 20958), (1, 1), (2, 5),
                                 (3, 300), (16, 33), (17, 300),
                                 (77, 2**20), (300, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_apply_cols_geometry_within_limits(m, d, dtype):
    """The launch geometry of K4: the pick's segment is the smallest power
    of two >= min(m, 32) lanes, within the block; every row of X owned by
    one segment, for the pick and every built override."""
    auto = sc.apply_cols_geometry(m, d, dtype)
    need = min(m, 32)
    assert auto.seg == next(w for w in (1, 2, 4, 8, 16, 32) if w >= need)
    assert auto.seg < 2 * need and auto.seg & (auto.seg - 1) == 0
    geoms = [auto] + [sc.apply_cols_geometry(m, d, dtype, seg=w)
                      for w in sc.APPLY_COLS_SEGS if w >= need]
    for geom in geoms:
        assert geom.threads == sc.APPLY_COLS_THREADS == 256
        assert geom.threads % geom.seg == 0 and geom.seg <= 32
        span = geom.threads // geom.seg                  # rows of X a block
        assert geom.blocks == -(-d // span) < 2**31
        assert (geom.blocks - 1) * span < d <= geom.blocks * span


@pytest.mark.parametrize("over,err", [
    ({"seg": 4}, ValueError), ({"seg": 64}, ValueError),
    ({"seg": 12}, ValueError), ({"seg": 0}, ValueError),
    ({"m": 2, "seg": 3}, ValueError), ({"m": 33, "seg": 16}, ValueError),
    ({"m": 0}, ValueError), ({"d": 0}, ValueError),
    ({"dtype": torch.bfloat16}, TypeError)])
def test_apply_cols_geometry_refuses_what_the_kernel_is_not_built_for(over,
                                                                       err):
    args = {"m": 8, "d": 1000, "dtype": torch.float32} | over
    m, d, dtype = args.pop("m"), args.pop("d"), args.pop("dtype")
    with pytest.raises(err):
        sc.apply_cols_geometry(m, d, dtype, **args)


def test_apply_cols_host_table_matches_what_the_source_builds():
    """sampled_cols.cu's K4 dispatch lists the segment widths and the block
    size the host may ask for."""
    import re
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1]
           / "src/repro_torch/csrc/sampled_cols.cu").read_text()
    body = src[src.index("int apply_impl("):src.index("#undef REPRO_APPLY\n")]
    segs = [int(w) for w in re.findall(r"REPRO_APPLY\((\d+)\)\n", body)]
    assert sorted(segs) == sorted(set(segs)) == list(sc.APPLY_COLS_SEGS)
    assert int(re.search(r"constexpr int APPLY_THREADS = (\d+);",
                         src).group(1)) == sc.APPLY_COLS_THREADS


def test_matvec_geometry_refuses_what_the_kernel_is_not_built_for():
    with pytest.raises(ValueError, match="built for"):
        sk.matvec_geometry(128, 1000, 1, torch.float32, "rows", rows=12)
    with pytest.raises(ValueError, match="built for"):
        sk.matvec_geometry(128, 1000, 1, torch.float32, "cols", stages=5)
    with pytest.raises(ValueError, match="built for"):
        sk.matvec_geometry(128, 1000, 1, torch.float32, "rows", steps=96)
    with pytest.raises(ValueError, match="multiple of 32"):
        sk.matvec_geometry(128, 1000, 1, torch.float32, "rows", 48)


def _operands(**over):
    args = {"X": torch.zeros((5, 7)),
            "flat": torch.tensor([0, 4], dtype=torch.int32),
            "vec": torch.zeros(7), "vec_len": 7, "n_index": 5, "what": "K"}
    args.update(over)
    return args


@pytest.mark.parametrize("over,err,match", [
    ({"flat": torch.tensor([0, 5], dtype=torch.int32)}, IndexError, "outside"),
    ({"flat": torch.tensor([-1, 2], dtype=torch.int32)}, IndexError,
     "outside"),
    ({"flat": torch.tensor([0, 1])}, TypeError, "int32"),
    ({"flat": torch.zeros(0, dtype=torch.int32)}, ValueError, "empty"),
    ({"X": torch.zeros((5, 7), dtype=torch.bfloat16)}, TypeError, "bf16"),
    ({"X": torch.zeros((7, 5)).T}, ValueError, "contiguous"),
    ({"vec": torch.zeros(6)}, ValueError, "length"),
    ({"vec": torch.zeros(7, dtype=torch.float64)}, TypeError, "dtype"),
])
def test_cuda_operand_checks_refuse_what_the_kernel_cannot_take(over, err,
                                                                match):
    with pytest.raises(err, match=match):
        check_cuda_operands(**_operands(**over))


def test_cuda_operand_checks_accept_valid_input():
    check_cuda_operands(**_operands())
    check_cuda_operands(**_operands(vec=torch.zeros((3, 7))), tenants=True)


@pytest.mark.parametrize("vec,tenants", [
    (torch.zeros((3, 7)), False),      # a tenant axis where none is taken
    (torch.zeros((0, 7)), True),       # no tenants
    (torch.zeros((2, 3, 7)), True)])   # two leading axes
def test_tenant_axis_only_where_the_kernel_takes_it(vec, tenants):
    with pytest.raises(ValueError, match="tensor"):
        check_cuda_operands(**_operands(vec=vec), tenants=tenants)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("layout", ["rows", "cols"])
@pytest.mark.parametrize("tenants", [0, 3])
def test_matvec_oracles_match_reference_and_packet_r(dt, shape, layout,
                                                     tenants):
    """The plain matvecs against the reference's oracles (one reference call
    per tenant), and equal to the port's packet r under torch.equal: the
    identity that makes batched solves equal single solves."""
    npdt, tdt, rtol, atol = DTYPES[dt]
    d, n, m = shape
    samples, K = (d, n) if layout == "rows" else (n, d)
    X, flat, rng = _inputs(d, n, m, npdt, samples, seed=6)
    t = rng.standard_normal((tenants, K) if tenants else K).astype(npdt)
    jfn = (jref.panel_matvec_ref if layout == "rows"
           else jref.panel_matvec_cols_ref)
    tfn = (tref.panel_matvec_ref if layout == "rows"
           else tref.panel_matvec_cols_ref)
    pfn = (tref.gram_packet_sampled_ref if layout == "rows"
           else tref.gram_packet_sampled_cols_ref)
    Xt, ft = torch.from_numpy(X), torch.from_numpy(flat)
    got = tfn(Xt, ft, torch.from_numpy(t), 0.5)
    assert got.dtype == tdt
    assert got.shape == ((tenants, m) if tenants else (m,))
    rows = got if tenants else got[None]
    for j, tj in enumerate(t if tenants else t[None]):
        _close(rows[j], jfn(jnp.asarray(X), jnp.asarray(flat),
                            jnp.asarray(tj), 0.5), rtol, atol)
        _, r = pfn(Xt, ft, torch.from_numpy(np.ascontiguousarray(tj)), 1.0,
                   0.0, 0.5)
        assert torch.equal(rows[j], r)


@pytest.mark.parametrize("dt", DTYPES)
def test_matvec_through_ops_matches_reference(dt):
    npdt, _, rtol, atol = DTYPES[dt]
    d, n, m = 21, 34, 10
    rng = np.random.default_rng(7)
    X = rng.standard_normal((d, n)).astype(npdt)
    Xt = torch.from_numpy(X)
    for op_t, op_j, samples, K in (
            (gk.RowMajorOperand(Xt), jnp.asarray(X), d, n),
            (gk.ColMajorOperand(Xt), JCols(jnp.asarray(X)), n, d)):
        flat = rng.integers(0, samples, m).astype(np.int32)
        t = rng.standard_normal(K).astype(npdt)
        out = gk.panel_matvec(op_t, torch.from_numpy(flat),
                              torch.from_numpy(t), scale=2.0,
                              plan=gk.PacketPlan(bk=64))
        want = j_matvec(op_j, jnp.asarray(flat), jnp.asarray(t), scale=2.0,
                        impl="ref")
        _close(out, want, rtol, atol)


# bf16 packets (K1, K3, K7): the reference's tolerance for bf16 against its
# f32-accumulating oracle (tests/test_kernels.py, 2e-2).  Both packages round
# the same f32 values to the same bf16 values (round to nearest even).
BF16_TOL = 2e-2


def _bf16_pair(a):
    """The same f32 array as a torch and a jnp bf16 array, checked equal."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    j = jnp.asarray(a, jnp.bfloat16)
    assert np.array_equal(t.float().numpy(), np.asarray(j, np.float32))
    return t, j


@pytest.mark.parametrize("shape", [(96, 512), (40, 300), (13, 128)])
@pytest.mark.parametrize("knobs", KNOBS)
def test_bf16_row_packet_matches_reference(shape, knobs):
    """K1's plain version in bf16 (what the wrapper runs on a CPU tensor)
    against the reference's impl="ref" oracle: f32 out, within 2e-2."""
    m, n = shape
    d = 2 * max(m, 16)
    X, flat, rng = _inputs(d, n, m, np.float32, d, seed=10)
    u = rng.standard_normal(n).astype(np.float32)
    (Xt, Xj), (ut, uj) = _bf16_pair(X), _bf16_pair(u)
    scale, reg, scale_r = knobs
    G, r = gk.gram_packet_sampled_rows(Xt, torch.from_numpy(flat), ut,
                                       scale=scale / n, reg=reg,
                                       scale_r=scale_r)
    Gj, rj = jref.gram_packet_sampled_ref(Xj, jnp.asarray(flat), uj,
                                          scale / n, reg, scale_r)
    assert G.dtype == r.dtype == torch.float32
    assert Gj.dtype == jnp.float32
    _close(G, Gj, BF16_TOL, BF16_TOL)
    _close(r, rj, BF16_TOL, BF16_TOL)


@pytest.mark.parametrize("shape", [(128, 512), (64, 300), (8, 128),
                                   (130, 700)])
def test_bf16_dense_packet_matches_reference(shape):
    """K7's plain version in bf16 against the reference's oracle, and equal
    to K1's on the rows it gathers (the identity the kernels keep)."""
    m, n = shape
    A, _, rng = _inputs(m, n, 1, np.float32, 1, seed=0)
    u = rng.standard_normal(n).astype(np.float32)
    (At, Aj), (ut, uj) = _bf16_pair(A), _bf16_pair(u)
    G, r = gk.gram_packet_dense(At, ut, scale=1.0 / n, reg=0.01)
    Gj, rj = jref.gram_packet_ref(Aj, uj, 1.0 / n, 0.01)
    assert G.dtype == r.dtype == torch.float32
    _close(G, Gj, BF16_TOL, BF16_TOL)
    _close(r, rj, BF16_TOL, BF16_TOL)
    flat = torch.arange(m, dtype=torch.int32)
    G1, r1 = gk.gram_packet_sampled_rows(At, flat, ut, scale=1.0 / n,
                                         reg=0.01)
    assert torch.equal(G, G1) and torch.equal(r, r1)


@pytest.mark.parametrize("shape", [(512, 96, 128), (300, 77, 40),
                                   (128, 40, 8)])
@pytest.mark.parametrize("knobs", KNOBS)
def test_bf16_cols_packet_matches_reference(shape, knobs):
    """K3's plain version in bf16 (what the wrapper runs on a CPU tensor)
    against the reference's gram_packet_sampled_cols_ref on the same bf16
    values: f32 out, within 2e-2 (the identities the kernels keep under
    torch.equal are held on the card, test_torch_cuda.py)."""
    d, n, m = shape
    X, flat, rng = _inputs(d, n, m, np.float32, n, seed=11)
    u = rng.standard_normal(d).astype(np.float32)
    (Xt, Xj), (ut, uj) = _bf16_pair(X), _bf16_pair(u)
    scale, reg, scale_r = knobs
    G, r = gk.gram_packet_sampled_cols(Xt, torch.from_numpy(flat), ut,
                                       scale=scale / d, reg=reg,
                                       scale_r=scale_r)
    Gj, rj = jref.gram_packet_sampled_cols_ref(Xj, jnp.asarray(flat), uj,
                                               scale / d, reg, scale_r)
    assert G.dtype == r.dtype == torch.float32
    assert Gj.dtype == jnp.float32
    _close(G, Gj, BF16_TOL, BF16_TOL)
    _close(r, rj, BF16_TOL, BF16_TOL)


def test_bf16_cols_packet_geometry_is_the_f32_one():
    """K3's bf16 build (the tensor-core tile on word slots) has its own
    picks, no longer the f32 ones: for every m and d a built geometry whose
    shared memory fits a block, at the bf16 chunk, which K7 takes when it
    is handed that chunk (so K3 == K7 on X[:, flat]^T); a geometry it is
    not built for is refused."""
    from repro_torch.kernels.gram import gram_kernel as gkk
    from repro_torch.kernels.gram import tuning
    for m in (1, 8, 16, 17, 77, 128, 200):
        for d in (128, 20958):
            geom = sc.cols_packet_geometry(m, d, torch.bfloat16)
            assert geom[:1] + geom[3:5] in gkk.MMA_BUILT["cols"]
            assert geom.smem <= sk.SMEM_PER_BLOCK
            assert geom.chunk == tuning.default_chunk(m, d, "cols",
                                                      torch.bfloat16)
            k7 = gkk.dense_geometry(m, d, torch.bfloat16, geom.chunk)
            assert (k7.bm, k7.chunk, k7.grid) == (geom.bm, geom.chunk,
                                                  geom.grid)
    with pytest.raises(ValueError, match="bfloat16 on cols"):
        sc.cols_packet_geometry(128, 2000, torch.bfloat16, stages=2)


@pytest.mark.parametrize("call", ["rows_apply", "cols_apply", "rows_matvec",
                                  "cols_matvec", "gram"])
def test_bf16_refused_by_the_kernels_without_a_bf16_build(call):
    """Only K1, K3 and K7 take bf16 on the card; the other kernels' checks
    refuse it before a launch, naming the kernel."""
    X = torch.zeros((5, 7), dtype=torch.bfloat16)
    names = {"rows_apply": gk.ROWS_APPLY, "cols_apply": gk.COLS_APPLY,
             "rows_matvec": gk.ROWS_MATVEC, "cols_matvec": gk.COLS_MATVEC,
             "gram": gk.DENSE_GRAM}
    name = names[call].name
    with pytest.raises(TypeError, match=f"{name}.*bf16"):
        if call == "gram":
            from repro_torch.kernels.gram import gram_kernel
            gram_kernel._check_operand(X, name)
        else:
            check_cuda_operands(X, torch.zeros(2, dtype=torch.int32),
                                torch.zeros(7, dtype=torch.bfloat16), 7, 5,
                                name)
    for info in gk.BF16_KERNELS:
        check_cuda_operands(X, torch.zeros(2, dtype=torch.int32),
                            torch.zeros(7, dtype=torch.bfloat16), 7, 5,
                            info.name, bf16=True)
