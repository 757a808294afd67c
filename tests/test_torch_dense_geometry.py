"""The host side of the dense Gram tile (``gram_kernel.py``) that K7 / K8 and
the sampled packets K1 (rows) and K3 (columns) launch: the launch geometry
worked out from the shapes alone, the tile order, and the buffers a launch
allocates.  No card
and no JAX needed: the kernels' own arithmetic is held to their plain
versions on the card (``tests/test_torch_cuda.py``).
"""
import itertools
import re
import statistics
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.gram import gram_kernel as gkk
from repro_torch.kernels.gram import sampled_colmajor as sc
from repro_torch.kernels.gram import sampled_kernel as sk
from repro_torch.kernels.gram import tuning

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
# (m, K): K8 at CholeskyQR's real-sim operand, K7 at the gathered panel, the
# sampled packets' other main widths, CholeskyQR's 8x cuts, ragged tests.
SHAPES = [(20958, 93267), (128, 72309), (8, 72309), (77, 72309),
          (2620, 11658), (1, 33), (129, 301), (300, 2000)]
DTYPES = [torch.float32, torch.float64]


def _every_geometry(dtype):
    for (bm, tm, tn), (stages, steps) in itertools.product(
            gkk.DENSE_TILES[dtype], gkk.DENSE_RINGS[dtype]):
        yield {"bm": bm, "micro": (tm, tn), "stages": stages, "steps": steps}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,K", SHAPES)
def test_dense_chunk_is_the_row_packets_pick(m, K, dtype):
    """The chunk fixes every sum, so it is K1's: then K7(X[flat]) == K1."""
    geom = gkk.dense_geometry(m, K, dtype)
    assert geom.chunk == tuning.pick_tiles(m, K, dtype, "rows")
    assert geom.chunk == sk.resolve_chunk(m, K, dtype, "rows", None)
    assert geom.splits == -(-K // geom.chunk) <= tuning.MAX_SPLITS
    assert gkk.dense_geometry(m, K, dtype, 64).chunk == 64


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,K", SHAPES)
def test_dense_tile_edge_from_m(m, K, dtype):
    """The widest tile edge whose lower tiles times chunks fill the card,
    else the narrowest: a small m never runs a mostly masked wide tile."""
    geom = gkk.dense_geometry(m, K, dtype)
    edges = sorted(t[0] for t in gkk.DENSE_TILES[dtype])
    blocks = {e: gkk.lower_tiles(m, e) * geom.splits for e in edges}
    full = [e for e in edges if blocks[e] >= gkk.DENSE_TARGET_BLOCKS]
    assert geom.bm == (max(full) if full else edges[0])
    if m <= 128:
        assert geom.bm < 128
    assert (geom.bm, geom.tm, geom.tn) in gkk.DENSE_TILES[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 8, 77, 128, 129, 300])
def test_row_packet_launches_the_dense_pick_at_its_own_chunk(m, dtype):
    """K1 launches the gathered tile at the geometry K7 would take on its
    gathered panel (so K1 == K7 bit for bit), at K1's chunk, and that
    geometry is one the gathered tile is built for."""
    for n in (72309, 2001):
        geom = sk.rows_packet_geometry(m, n, dtype)
        assert geom == gkk.dense_geometry(m, n, dtype)._replace(source="rows")
        assert geom.source == "rows"
        assert geom.chunk == sk.resolve_chunk(m, n, dtype, "rows", None)
        assert (geom.bm, geom.tm, geom.tn) in gkk.GATHERED_TILES[dtype]
        assert (geom.stages, geom.steps) == gkk.DENSE_RING
        assert sk.rows_packet_geometry(m, n, dtype, 64).chunk == 64


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_pick_is_built_gathered(dtype):
    """Whatever m K1 is given, the dense pick has a gathered instantiation."""
    for m in list(range(1, 300)) + [1000, 2900, 4096, 20958]:
        for K in (301, 72309):
            geom = gkk.dense_geometry(m, K, dtype)
            assert (geom.bm, geom.tm, geom.tn) in gkk.GATHERED_TILES[dtype]
    assert {t[0] for t in gkk.GATHERED_TILES[dtype]} == {
        t[0] for t in gkk.DENSE_TILES[dtype]}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 8, 77, 128, 129, 300])
def test_col_packet_launches_at_its_own_chunk(m, dtype):
    """K3 launches the gathered-column tile at K3's own chunk (so K3 equals
    K7 on X[:, flat]^T at that chunk, and K5 equals K3's r), at a geometry
    it is built for: the narrowest built tile edge that holds min(m, 32)
    panel rows."""
    edges = sorted({g[0] for g in gkk.COLS_BUILT[dtype]})
    for d in (20958, 301):
        geom = sc.cols_packet_geometry(m, d, dtype)
        assert geom.chunk == tuning.default_chunk(m, d, "cols")
        assert geom.chunk == sk.resolve_chunk(m, d, dtype, "cols", None)
        assert geom.splits == -(-d // geom.chunk)
        assert geom[:5] in gkk.COLS_BUILT[dtype]
        assert geom.source == "cols"
        assert geom.bm == next(e for e in edges if e >= min(m, 32))
        assert geom.bm == (16 if m <= 16 else 32)
        assert geom.grid == (gkk.lower_tiles(m, geom.bm), geom.splits)
        assert geom.smem == gkk.ring_bytes(geom.bm, geom.stages, geom.steps,
                                           dtype) <= sk.SMEM_PER_BLOCK
        assert sc.cols_packet_geometry(m, d, dtype, 64).chunk == 64


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_col_pick_is_built(dtype):
    """Whatever m K3 is given, its pick is a built gathered-column geometry
    whose ring fits a block; every built geometry can be asked for by its
    tile edge alone and launches whole warps."""
    for m in list(range(1, 300)) + [1000, 2900, 4096, 20958]:
        for d in (301, 20958):
            geom = sc.cols_packet_geometry(m, d, dtype)
            assert geom[:5] in gkk.COLS_BUILT[dtype]
            assert geom.smem <= sk.SMEM_PER_BLOCK
    for built in gkk.COLS_BUILT[dtype]:
        geom = sc.cols_packet_geometry(77, 20958, dtype, bm=built[0])
        assert geom[:5] == built
        assert geom.threads % 32 == 0 and geom.threads % geom.bm == 0


@pytest.mark.parametrize("m,K", SHAPES)
def test_bf16_packets_take_the_f32_geometry_and_chunk(m, K):
    """bf16 K7 / K1 / K3 run the tensor-core tile at their own picks (no
    longer the f32 ones): the tile edge from m alone, a built ring whose
    shared memory fits a block, the same chunk and geometry for K1 and K7
    (so K1 == K7 on the gathered rows), and K3's chunk handed to K7 keeps
    K7 at K3's tile edge (so K3 == K7 on X[:, flat]^T); the matvecs take no
    bf16."""
    bf16 = torch.bfloat16
    k7 = gkk.dense_geometry(m, K, bf16)
    k1 = sk.rows_packet_geometry(m, K, bf16)
    assert k7[:-1] == k1[:-1] and (k7.source, k1.source) == ("dense", "rows")
    assert k1.chunk == tuning.default_chunk(m, K, "rows", bf16)
    k3 = sc.cols_packet_geometry(m, K, bf16)
    assert k3.chunk == tuning.default_chunk(m, K, "cols", bf16)
    at_k3 = gkk.dense_geometry(m, K, bf16, k3.chunk)
    assert (at_k3.bm, at_k3.chunk, at_k3.splits) == (k3.bm, k3.chunk,
                                                     k3.splits)
    for geom in (k7, k1, k3, at_k3):
        assert geom.bm == tuning.mma_edge(m) == (16 if m <= 16 else 128)
        assert (geom.tm, geom.tn) == gkk.MMA_MICRO
        assert geom[:1] + geom[3:5] in gkk.MMA_BUILT[geom.source]
        assert geom.threads == gkk.MMA_THREADS == 128
        assert geom.grid == (gkk.lower_tiles(m, geom.bm), geom.splits)
        assert geom.smem == gkk.mma_bytes(geom.bm, geom.stages, geom.steps,
                                          geom.source, geom.grid[0])
        assert 0 < geom.smem <= sk.SMEM_PER_BLOCK == 232448
        assert geom.splits == -(-K // geom.chunk) <= tuning.MAX_SPLITS
    with pytest.raises(TypeError, match="K5 / K6"):
        sk.matvec_geometry(m, K, 1, torch.bfloat16, "rows")


# The f32 / f64 picks at the real-sim shapes, as they stood before the bf16
# packets moved to the tensor cores (bf16 has its own picks and chunk now;
# these must not move): (bm, tm, tn, stages, steps, threads, grid, smem,
# group, chunk, splits, source).
PINNED = {
    ("rows", 8, torch.float32): (32, 4, 4, 3, 16, 64, (1, 252), 14016, 16,
                                 288, 252, "rows"),
    ("rows", 128, torch.float32): (32, 4, 4, 3, 16, 64, (10, 103), 14016, 16,
                                   704, 103, "rows"),
    ("cols", 8, torch.float32): (16, 2, 2, 3, 32, 64, (1, 73), 15744, 16, 288,
                                 73, "cols"),
    ("cols", 128, torch.float32): (32, 4, 4, 4, 8, 64, (10, 13), 9344, 16,
                                   1632, 13, "cols"),
    ("dense", 20958, torch.float32): (128, 8, 8, 3, 16, 256, (13530, 1),
                                      50880, 16, 93280, 1, "dense"),
    ("rows", 8, torch.float64): (32, 4, 4, 3, 16, 64, (1, 252), 26496, 16,
                                 288, 252, "rows"),
    ("rows", 128, torch.float64): (32, 4, 4, 3, 16, 64, (10, 103), 26496, 16,
                                   704, 103, "rows"),
    ("cols", 8, torch.float64): (16, 2, 2, 3, 32, 64, (1, 73), 28416, 16, 288,
                                 73, "cols"),
    ("cols", 128, torch.float64): (32, 4, 4, 4, 8, 64, (10, 13), 17664, 16,
                                   1632, 13, "cols"),
    ("dense", 20958, torch.float64): (64, 4, 4, 3, 16, 256, (53956, 1), 51072,
                                      16, 93280, 1, "dense")}


@pytest.mark.parametrize("source,m,dtype", sorted(PINNED, key=str))
def test_f32_f64_picks_at_real_sim_are_unchanged(source, m, dtype):
    """K1 / K7 at n = 72309 (K8 at CholeskyQR's 93267), K3 at d = 20958:
    the f32 and f64 geometry and chunk, and the matvecs' chunk, which must
    equal the packets' so that K5 / K6 equal K3 / K1's r."""
    K = {"rows": 72309, "cols": 20958, "dense": 93267}[source]
    geom = (sc.cols_packet_geometry(m, K, dtype) if source == "cols" else
            gkk.dense_geometry(m, K, dtype, source=source))
    assert tuple(geom) == PINNED[(source, m, dtype)]
    assert geom.chunk == tuning.default_chunk(
        m, K, "cols" if source == "cols" else "rows")
    if source != "dense":
        assert sk.matvec_geometry(m, K, 8, dtype, source).chunk == geom.chunk


def test_dense_tile_edge_at_the_main_shapes():
    f32 = torch.float32
    assert gkk.dense_geometry(20958, 93267, f32).bm == 128     # K8
    assert gkk.dense_geometry(20958, 93267, f32).splits == 1
    assert gkk.dense_geometry(8, 72309, f32).bm == 32
    assert gkk.dense_geometry(77, 72309, f32).bm <= 64


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,K", [(20958, 93267), (128, 72309), (77, 301)])
def test_every_built_geometry_fits_a_block(m, K, dtype):
    """Grid, threads and shared memory of every geometry the kernel is built
    for: within the card's limits, and the grid one block per (lower tile,
    chunk)."""
    for over in _every_geometry(dtype):
        geom = gkk.dense_geometry(m, K, dtype, **over)
        nt = -(-m // geom.bm)
        assert geom.grid == (nt * (nt + 1) // 2, geom.splits)
        assert geom.threads == (geom.bm // geom.tm) * (geom.bm // geom.tn)
        assert geom.threads % 32 == 0 and geom.threads <= 1024
        assert geom.smem == gkk.ring_bytes(geom.bm, geom.stages, geom.steps,
                                           dtype)
        assert 0 < geom.smem <= sk.SMEM_PER_BLOCK == 232448
        assert geom.smem % 16 == 0
        assert geom.chunk == gkk.dense_geometry(m, K, dtype).chunk


@pytest.mark.parametrize("bm,stages,steps,dtype,want", [
    (128, 3, 16, torch.float32, 3 * (2 * 16 * 132 + 16) * 4),
    (32, 2, 8, torch.float32, 2 * (2 * 8 * 36 + 8) * 4),
    (64, 3, 16, torch.float64, 3 * (2 * 16 * 66 + 16) * 8)])
def test_ring_bytes_counts_two_operands_and_u(bm, stages, steps, dtype, want):
    assert gkk.ring_bytes(bm, stages, steps, dtype) == want


@pytest.mark.parametrize("bm,stages,steps,source,tiles,want", [
    # 260 ints of offsets and 258 8-byte sources, then per stage 128 raw
    # rows of 9 chunks and u's; with a tile below the diagonal operand j's
    # 128 rows too
    (128, 3, 64, "rows", 1, 4 * 260 + 8 * 258 + 4 * 3 * (128 * 36 + 36)),
    (128, 3, 64, "rows", 3, 4 * 260 + 8 * 258 + 4 * 3 * (256 * 36 + 36)),
    (16, 4, 128, "dense", 1, 4 * 36 + 8 * 34 + 4 * 4 * (16 * 68 + 68)),
    # word slots: 4 bytes a step, u still a raw row
    (128, 3, 32, "cols", 1, 4 * 260 + 8 * 258 + 4 * 3 * (128 * 32 + 20)),
    (128, 3, 32, "cols", 3, 4 * 260 + 8 * 258 + 4 * 3 * (256 * 32 + 20)),
    (16, 3, 32, "cols", 1, 4 * 36 + 8 * 34 + 4 * 3 * (16 * 32 + 20))])
def test_mma_bytes_counts_info_panel_rows_and_u(bm, stages, steps, source,
                                                tiles, want):
    """mma_tile's shared memory (csrc/dense_tile.cuh, MmaTile): the rows'
    offsets and sources, then per stage operand i's panel rows (and j's
    where a tile lies below the diagonal) and u's raw row; the kernel
    refuses a launch whose count differs."""
    assert gkk.mma_bytes(bm, stages, steps, source, tiles) == want


@pytest.mark.parametrize("over,err", [
    ({"bm": 48}, ValueError), ({"bm": 128, "micro": (4, 4)}, ValueError),
    ({"stages": 5}, ValueError), ({"steps": 24}, ValueError),
    ({"group": 0}, ValueError),
    ({"source": "rows", "bm": 64, "micro": (8, 8)}, ValueError),
    ({"source": "rows", "stages": 2}, ValueError),
    ({"source": "rows", "steps": 32}, ValueError),
    ({"source": "cols", "bm": 128, "micro": (8, 8)}, ValueError),
    ({"source": "cols", "bm": 16, "micro": (4, 4)}, ValueError),
    ({"source": "cols", "stages": 5}, ValueError),
    ({"source": "cols", "bm": 32, "steps": 16}, ValueError),
    ({"source": "gathered"}, ValueError)])
def test_dense_geometry_refuses_what_the_kernel_is_not_built_for(over, err):
    with pytest.raises(err):
        gkk.dense_geometry(128, 1000, torch.float32, **over)


def test_launch_dense_refuses_flat_that_does_not_match_the_source():
    """The geometry's source decides what launch_dense launches: a dense
    geometry takes no index vector, a gathered one needs it.  Refused before
    anything touches a device."""
    f32 = torch.float32
    A, u = torch.ones((8, 64)), torch.ones(64)
    flat = torch.zeros(8, dtype=torch.int32)
    for geom, f in ((gkk.dense_geometry(8, 64, f32), flat),
                    (sk.rows_packet_geometry(8, 64, f32), None),
                    (sc.cols_packet_geometry(8, 8, f32), None)):
        with pytest.raises(ValueError, match="flat"):
            gkk.launch_dense(gkk.DENSE_PACKET, A, u, geom, 1.0, 0.0, None, f)


def test_dense_geometry_refuses_f64_wide_tiles_and_other_dtypes():
    with pytest.raises(ValueError):
        gkk.dense_geometry(128, 1000, torch.float64, bm=128, micro=(8, 8))
    with pytest.raises(ValueError):
        gkk.dense_geometry(128, 1000, torch.float64, stages=2, steps=8)
    with pytest.raises(TypeError):
        gkk.dense_geometry(128, 1000, torch.float16)
    # bf16 (K7, K1, K3 on the tensor cores) is built at its picks alone
    with pytest.raises(ValueError, match="bfloat16 on cols"):
        gkk.dense_geometry(128, 1000, torch.bfloat16, source="cols",
                           stages=2)
    with pytest.raises(TypeError):
        gkk.dense_geometry(128, 1000, torch.float16, source="cols")
    with pytest.raises(ValueError):
        gkk.dense_geometry(128, 1000, torch.bfloat16, stages=2, steps=8)
    with pytest.raises(ValueError, match="multiple"):
        gkk.dense_geometry(128, 1000, torch.float32, 48)


def _as_int(t):
    return tuple(map(int, t))


def _mma_built(src, entry):
    """The (bm, stages, steps) a source's bf16 dispatch (REPRO_MMA lines
    after ``entry``) builds mma_tile for."""
    body = src[src.index(entry):]
    body = body[:body.index("#undef REPRO_MMA")]
    return {_as_int(t) for t in
            re.findall(r"REPRO_MMA\((\d+), (\d+), (\d+)\)\n", body)}


@pytest.mark.parametrize("kernel", ["dense", "gathered", "cols"])
def test_host_table_matches_what_the_source_builds(kernel):
    """gram_dense.cu's dispatch (K7 / K8), sampled_rows.cu's (K1) and
    sampled_cols.cu's (K3) list the geometries the host may ask for."""
    tile = r"REPRO_TILE\((\d+), (\d+), (\d+), (\d+), (\d+)\)\n"
    if kernel == "cols":
        src = (CSRC / "sampled_cols.cu").read_text()
        body = src[src.index("int packet_impl("):
                   src.index("#undef REPRO_TILE")]
        built = {_as_int(t) for t in re.findall(tile, body)}
        # one list for f32 and f64; bf16 runs mma_tile
        assert set(gkk.COLS_BUILT) == set(DTYPES)
        for dtype in gkk.COLS_BUILT:
            assert built == set(gkk.COLS_BUILT[dtype])
        assert _mma_built(src, "int packet_bf16(") == set(
            gkk.MMA_BUILT["cols"])
        return
    if kernel == "gathered":
        src = (CSRC / "sampled_rows.cu").read_text()
        body = src[src.index("int packet_impl("):
                   src.index("#undef REPRO_TILE")]
        f32, f64 = body.split("} else {")
        for dtype, part in ((torch.float32, f32), (torch.float64, f64)):
            built = {_as_int(t) for t in re.findall(tile, part)}
            assert built == {t + gkk.DENSE_RING
                             for t in gkk.GATHERED_TILES[dtype]}
        assert _mma_built(src, "int packet_bf16(") == set(
            gkk.MMA_BUILT["rows"])
        return
    src = (CSRC / "gram_dense.cu").read_text()
    rings = set(re.findall(r"REPRO_TILE\(B, M, N, (\d+), (\d+)\)", src))
    f32 = set(re.findall(r"REPRO_RINGS\((\d+), (\d+), (\d+)\)\n", src))
    body = src[src.index("int dense_impl("):src.index("#undef REPRO_RINGS")]
    f64 = set(re.findall(tile, body.split("} else {")[1]))
    assert _mma_built(src, "int dense_bf16(") == set(gkk.MMA_BUILT["dense"])
    assert {_as_int(t) for t in rings} == set(gkk.DENSE_RINGS[torch.float32])
    assert {_as_int(t) for t in f32} == set(gkk.DENSE_TILES[torch.float32])
    assert {_as_int(t)[:3] for t in f64} == set(
        gkk.DENSE_TILES[torch.float64])
    assert {_as_int(t)[3:] for t in f64} == set(
        gkk.DENSE_RINGS[torch.float64])


@pytest.mark.parametrize("nt,group", [(1, 16), (3, 1), (7, 2), (10, 4),
                                      (164, 16), (164, 1000), (655, 16)])
def test_tile_order_lists_every_lower_tile_once(nt, group):
    order = gkk.tile_order(nt, group)
    want = {(ti, tj) for ti in range(nt) for tj in range(ti + 1)}
    assert len(order) == len(want) == nt * (nt + 1) // 2
    assert set(order) == want
    strips = [ti // group for ti, _ in order]
    assert strips == sorted(strips)          # strip by strip
    packed = gkk.dense_tiles(torch.device("cpu"), nt, group)
    assert packed.dtype == torch.int32 and packed.numel() == len(order)
    assert [(int(v) >> 16, int(v) & 0xFFFF) for v in packed] == order


def test_tile_order_keeps_resident_blocks_on_few_bands():
    """At K8's 164 bands, a window of 264 consecutive tiles (two resident
    blocks a SM) touches, in the median, about 2 sqrt(264) row bands of A:
    a third of what a row-by-row order touches."""
    def bands(order):
        return statistics.median(
            len({b for t in order[i:i + 264] for b in t})
            for i in range(0, len(order) - 264, 97))
    grouped = bands(gkk.tile_order(164, gkk.DENSE_GROUP))
    by_rows = bands([(ti, tj) for ti in range(164) for tj in range(ti + 1)])
    assert grouped <= 40 and 3 * grouped < by_rows


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("m,K", [(20958, 93267), (2620, 11658), (128, 72309),
                                 (77, 301)])
def test_partial_buffers_only_at_more_than_one_split(m, K, residual):
    """At one split (K8 at real-sim) the kernel writes G itself: no partial
    buffer; at more, (splits, mp, mp) partials for the reduce pass."""
    geom = gkk.dense_geometry(m, K, torch.float32)
    # shapes only: allocate on the meta device
    G, r, Gp, rp = gkk.dense_buffers(m, geom, residual, dtype=torch.float32,
                                     device="meta")
    assert G.shape == (m, m)
    assert (r is not None) == residual and (r is None or r.shape == (m,))
    mp = -(-m // tuning.TILE) * tuning.TILE
    if geom.splits == 1:
        assert Gp is None and rp is None
    else:
        assert Gp.shape == (geom.splits, mp, mp)
        assert rp is None if not residual else rp.shape == (geom.splits, mp)
    assert (geom.splits == 1) == (m in (20958, 2620, 77))


def test_sass_mix_reads_the_longest_ffma_loop():
    """The instruction-mix reader used on the card: opcodes without
    predicates or modifiers, and the loop of a backward branch."""
    from repro_torch.launch import sass_mix
    listing = """
        Function : _Z3fooPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;   /* 0x000 */
        /*0010*/                   LDS.128 R4, [R2] ;       /* 0x000 */
        /*0020*/                   FFMA R8, R4, R5, R8 ;    /* 0x000 */
        /*0030*/                   FFMA R9, R4, R6, R9 ;    /* 0x000 */
        /*0040*/              @!P0 BRA 0x10 ;               /* 0x000 */
        /*0050*/                   BRA 0x50 ;               /* 0x000 */
        /*0060*/                   EXIT ;                   /* 0x000 */
        Function : _Z3barv
        /*0000*/                   EXIT ;                   /* 0x000 */
"""
    funcs = sass_mix.functions(listing)
    assert list(funcs) == ["_Z3fooPf", "_Z3barv"]
    mix = sass_mix.loop_mix(funcs["_Z3fooPf"])
    assert mix["instructions"] == 7 and mix["loop_instructions"] == 4
    assert mix["loop_opcodes"] == {"FFMA": 2, "LDS": 1, "BRA": 1}
    assert mix["loop_ffma_share"] == 0.5
    assert sass_mix.loop_mix(funcs["_Z3barv"])["loop_instructions"] == 0


def test_sass_mix_demangles_in_order():
    import shutil
    from repro_torch.launch import sass_mix
    if shutil.which("c++filt") is None:
        pytest.skip("needs c++filt (binutils)")
    assert sass_mix.demangle(["_Z3fooPf", "_Z3barv"]) == ["foo(float*)",
                                                          "bar()"]


def test_ptxas_report_compares_kernel_by_kernel(capsys):
    """launch/ptxas_report.py's comparison: equal lines pass, a changed or
    missing kernel fails, a kernel only in the second file (a new build)
    passes."""
    from repro_torch.launch import ptxas_report
    a = {"x.cu:k1": ["Used 96 registers"], "x.cu:k2": ["Used 40 registers"]}
    assert ptxas_report.compare(a, dict(a, **{"x.cu:k3": ["Used 8"]}))
    assert not ptxas_report.compare(a, dict(a, **{"x.cu:k2": ["Used 41"]}))
    assert not ptxas_report.compare(a, {"x.cu:k1": a["x.cu:k1"]})
    assert "1 differ" in capsys.readouterr().out
    assert ptxas_report._ANON.sub("_GLOBAL__N__", "_ZN48_GLOBAL__N__29a5fd"
                                  "ca_15_rows") == "_ZN48_GLOBAL__N__15_rows"


def test_ptxas_report_pairs_the_kernels_of_an_edited_source(capsys):
    """An anonymous-namespace kernel's name carries a hash of its source
    as well as the build's: an edit anywhere in the source moves it, so the
    comparison takes both out, and an unchanged kernel of an edited source
    still pairs with the parent's."""
    from repro_torch.launch import ptxas_report
    raw = "_ZN48_GLOBAL__N__29a5fdca_15_sampled_rows_cu_{}10rows_applyIfEv"
    lines = ["Used 40 registers"]
    a = {"s.cu:" + ptxas_report._name(raw.format("0132b837")): lines}
    b = {"s.cu:" + ptxas_report._name(raw.format("1ea0f816")): lines}
    assert ptxas_report.compare(*(
        {ptxas_report._name(k): v for k, v in d.items()} for d in (a, b)))
    assert "1 kernels equal, 0 differ" in capsys.readouterr().out


def test_bf16_packet_inputs_come_from_the_seed_alone():
    """launch/bf16_packets.py's inputs (phase 2c's, and a parent tree's in
    the same call): per m in (128, 8), indices in range in blocks of 8 with
    a duplicate across blocks, u of the contraction's length, the same
    from the same seed and other from another."""
    from repro_torch.launch import bf16_packets as bp
    Xb = torch.zeros((300, 500), dtype=torch.bfloat16)
    a, b, c = bp.cases(Xb, 0), bp.cases(Xb, 0), bp.cases(Xb, 1)
    assert [case["m"] for case in a] == list(bp.MS) == [128, 8]
    for case, same, other in zip(a, b, c):
        m = case["m"]
        for key, hi in (("flat", 300), ("flat_c", 500)):
            flat = case[key]
            assert flat.dtype == torch.int32 and flat.shape == (m,)
            assert 0 <= int(flat.min()) and int(flat.max()) < hi
            blocks = flat.view(m // 8, 8)
            assert all(len(set(row.tolist())) == 8 for row in blocks)
            if m > 8:
                assert len(set(flat.tolist())) < m     # across blocks
            assert torch.equal(flat, same[key])
            assert not torch.equal(flat, other[key])
        assert case["u"].shape == (500,) and case["u_c"].shape == (300,)
        assert case["u"].dtype == case["u_c"].dtype == torch.bfloat16
        assert torch.equal(case["u"], same["u"])
