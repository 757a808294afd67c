"""Wrappers of the dense Gram CUDA kernels K7 and K8 (``csrc/gram_dense.cu``),
on an operand A (m, K) that is already materialised, and the host side of
their tile kernel ``dense_tile`` (``csrc/dense_tile.cuh``), which the
sampled packets also launch in place: K1
(``sampled_kernel.gram_packet_sampled_rows``) on the rows ``X[flat]`` of X,
K3 (``sampled_colmajor.gram_packet_sampled_cols``) on its columns
``X[:, flat]``.

* :func:`gram_packet_dense` (K7) -- ``(G, r) = (scale * A A^T + reg * I,
  scale_r * A u)``.  Replaces ``gram_packet_pallas`` (``src/repro/kernels/
  gram/gram_kernel.py``).  It takes K1's chunk for the same (m, K) and sums
  every entry in K1's order, so ``K7(X[flat], u)`` equals
  ``K1(X, flat, u)`` bit for bit.  Bounded by its m(m+1)/2 * K
  multiply-adds on the f32 CUDA cores.  Like K1 it also takes bf16 A and u
  (f32 sums and outputs, on the tensor cores: ``mma_tile``, at K1's bf16
  geometry and chunk, so it equals bf16 K1 on the gathered rows; counted
  apart, :data:`DENSE_PACKET_BF16`).
* :func:`gram_dense` (K8) -- ``G = scale * A A^T + reg * I``.  Replaces
  ``gram_pallas`` (same file): K7 with the residual statically absent, so
  its G equals K7's G bit for bit.  The R-factor Gram of CholeskyQR
  (``core.tsqr.cholqr_r``).

All three launch ``dense_tile``: register-blocked lower BM x BM tiles of G
fed by a ``cp.async`` ring, one block per (tile, contraction chunk), the
tiles in the order of :func:`dense_tiles`; bf16 input launches ``mma_tile``
(the same tiles and chunks, tensor-core products, :data:`MMA_BUILT`).  The
launch geometry comes from :func:`dense_geometry`, from the shapes alone;
only the chunk (and for bf16 the tile edge, which follows m) fixes a sum.
At one chunk the kernel writes G itself and no partial buffer is
allocated; at more, the chunk partials go through ``dense_reduce``.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches the
kernel or raises.  A must be contiguous: the wrappers never copy it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build, ref, tuning
from .sampled_kernel import (D, I, I64, P, PACKET_SUFFIX, SMEM_PER_BLOCK,
                             check_matrix, check_vector, resolve_chunk)

DENSE_PACKET = _build.KernelInfo(
    "gram_packet_dense", "src/repro_torch/csrc/gram_dense.cu",
    "src/repro/kernels/gram/gram_kernel.py:112")
DENSE_PACKET_BF16 = _build.KernelInfo(
    "gram_packet_dense_bf16", "src/repro_torch/csrc/gram_dense.cu",
    "src/repro/kernels/gram/gram_kernel.py:112")
DENSE_GRAM = _build.KernelInfo(
    "gram_dense", "src/repro_torch/csrc/gram_dense.cu",
    "src/repro/kernels/gram/gram_kernel.py:161")

# dense_packet_*(A, u, tiles, Gp, rp, G, r, K, m, chunk, splits, bm, tm, tn,
#                stages, steps, ntiles, smem, scale, reg, scale_r, stream);
# dense_gram_*(A, tiles, Gp, G, K, m, chunk, splits, bm, tm, tn, stages,
#              steps, ntiles, smem, scale, reg, stream);
# rows_packet_*(X, flat, u, tiles, Gp, rp, G, r, n, m, chunk, ...) as
#               dense_packet_* with flat after X (sampled_rows.cu);
# cols_packet_*(X, flat, u, tiles, Gp, rp, G, r, d, n, m, chunk, ...) as
#               rows_packet_* with X's row length n after d (sampled_cols.cu)
_GEOM_ARGS = (I, I, I, I, I, I, I)
_PACKET_ARGS = (P,) * 7 + (I64, I, I64, I) + _GEOM_ARGS + (D, D, D, P)
_GRAM_ARGS = (P,) * 4 + (I64, I, I64, I) + _GEOM_ARGS + (D, D, P)
_ROWS_PACKET_ARGS = (P,) + _PACKET_ARGS
_COLS_PACKET_ARGS = (P,) * 8 + (I64, I64, I, I64, I) + _GEOM_ARGS + (D, D, D,
                                                                     P)

# The geometries dense_tile is built for, per dtype: (tile edge BM, micro-tile
# rows TM, columns TN) and the rings (stages, steps per stage).
DENSE_TILES = {torch.float32: ((128, 8, 8), (64, 4, 4), (64, 8, 8),
                               (32, 4, 4)),
               torch.float64: ((64, 4, 4), (32, 4, 4))}
DENSE_RINGS = {torch.float32: tuple((s, q) for s in (2, 3, 4)
                                    for q in (8, 16, 32)),
               torch.float64: ((3, 16),)}
# The picks, from launch.tile_sweep's dense sweep (PERF.md).  The tile: the
# widest whose lower tiles times chunks give at least DENSE_TARGET_BLOCKS
# blocks (four a SM on 132 SMs: the 128-tile at K8's real-sim operand, the
# 32-tile at K7's 103 chunks, where the 128- and 64-tiles leave SMs idle),
# else the narrowest; its micro-tile the first listed.  The ring (stages,
# steps), within 1 % of the best at both shapes; and the row bands per
# strip of the tile order.
DENSE_TARGET_BLOCKS = 4 * 132
DENSE_RING = (3, 16)
DENSE_GROUP = 16
# Where dense_tile reads its panel rows (csrc/dense_tile.cuh's Source): a
# materialised A (K7 / K8), the rows X[flat] of X (K1) or its columns
# X[:, flat] (K3).  The source fixes the chunk's layout (K3's own for
# "cols", K1's else) and the geometries built.
SOURCES = ("dense", "rows", "cols")
# The geometries the gathered tile (K1, sampled_rows.cu) is built for: the
# picks alone, every tile edge with its first micro-tile at DENSE_RING.
GATHERED_TILES = {torch.float32: ((128, 8, 8), (64, 4, 4), (32, 4, 4)),
                  torch.float64: ((64, 4, 4), (32, 4, 4))}
# The geometries the gathered-column tile (K3, sampled_cols.cu) is built
# for, per dtype, as (bm, tm, tn, stages, steps): the picks alone, from
# launch.tile_sweep's cols sweep (PERF.md).  The tile edge is the narrowest
# that holds min(m, 32) panel rows: at the solve's m = 8 the 16-tile (2 x 2
# a thread) sums a chunk in fewer instructions a thread than the 32-tile;
# past 16 rows the 32-tile, whose blocks read each sampled column from 4
# tiles at m = 128 (the 64-tile's 39 blocks and the 16-tile's 8 reads a
# column are slower).  A sampled column has no two elements in one sector;
# the rings that read best keep few steps in flight, (stages, steps) =
# (3, 32) at m = 8 and (4, 8) at m = 128 (where deeper and shallower rings
# alike read up to 2x slower, in no monotone order).
COLS_BUILT = {dtype: ((16, 2, 2, 3, 32), (32, 4, 4, 4, 8))
              for dtype in (torch.float32, torch.float64)}
# bf16 input (K7, K1, K3) runs the tensor-core tile mma_tile
# (csrc/dense_tile.cuh), built per source for (tile edge, stages, steps):
# the tile edge is tuning.mma_edge(m) (16 up to m = 16, else 128, for every
# source, so K1, K3 and K7 at one m sum alike), four warps a block, the
# micro-tile the 16 x 8 product.  The rings, from launch.tile_sweep's bf16
# sweep: raw rows (K7, K1) 3 stages of 64 steps at the 128-tile (5 stages,
# or 192 or 256 steps, read no faster), 4 of 128 at the 16-tile (the m = 8
# chunk of 288 steps in flight at once); word slots (K3) 3 stages of 32 at
# both tile edges (2 and 6 read slower at the 128-tile's chunk).
MMA_BUILT = {"dense": ((16, 4, 128), (128, 3, 64)),
             "rows": ((16, 4, 128), (128, 3, 64)),
             "cols": ((16, 3, 32), (128, 3, 32))}
MMA_MICRO = (16, 8)
MMA_THREADS = 128


class DenseGeometry(NamedTuple):
    """How a K7 / K8 launch is cut: lower ``bm`` x ``bm`` tiles with a
    ``tm`` x ``tn`` micro-tile a thread (``threads`` a block), a ring of
    ``stages`` stages of ``steps`` contraction steps (``smem`` bytes of
    dynamic shared memory), ``grid`` = (lower tiles, splits), the tiles in
    strips of ``group`` row bands, the contraction ``chunk`` with its
    ``splits``, and the ``source`` of the panel rows (:data:`SOURCES`)."""
    bm: int
    tm: int
    tn: int
    stages: int
    steps: int
    threads: int
    grid: tuple
    smem: int
    group: int
    chunk: int
    splits: int
    source: str


def ring_bytes(bm: int, stages: int, steps: int, dtype: torch.dtype) -> int:
    """Shared memory of dense_tile's ring: per stage two k-major operands of
    ``steps`` rows of bm + 16 bytes, and ``steps`` elements of u."""
    isz = torch.empty((), dtype=dtype).element_size()
    return stages * (2 * steps * (bm + 16 // isz) + steps) * isz


def mma_bytes(bm: int, stages: int, steps: int, source: str,
              tiles: int = 1) -> int:
    """Shared memory of mma_tile (csrc/dense_tile.cuh's MmaTile) for a
    launch of ``tiles`` lower tiles: an int of each panel row's offset or
    halves (2 bm + 1 with u's, in whole 16-byte groups) and an 8-byte
    source address of each (2 bm + 2), then per stage operand i's bm panel
    rows, operand j's bm more where there is a tile below the diagonal
    (tiles > 1), and u's raw row.  A raw row is steps / 8 + 1 16-byte
    chunks (the misaligned start); a row of word slots (source "cols") 4
    bytes a step."""
    ch = steps // 8 + 1
    ldw = steps if source == "cols" else 4 * ch
    info = -(-(2 * bm + 1) // 4) * 4
    rows = (2 if tiles > 1 else 1) * bm
    return 4 * info + 8 * (2 * bm + 2) + 4 * stages * (rows * ldw + 4 * ch)


def lower_tiles(m: int, bm: int) -> int:
    nt = -(-m // bm)
    return nt * (nt + 1) // 2


def dense_geometry(m: int, K: int, dtype: torch.dtype, bk: int | None = None,
                   *, bm: int | None = None, micro: tuple | None = None,
                   stages: int | None = None, steps: int | None = None,
                   group: int | None = None, source: str = "dense"
                   ) -> DenseGeometry:
    """The launch geometry of dense_tile from the shapes alone: with
    ``source`` "dense" of K7 / K8 on an (m, K) operand of ``dtype``, "rows"
    of K1 on m rows of X (K = n), "cols" of K3 on m columns of X (K = d).
    The chunk is K3's for "cols", else K1's (:func:`resolve_chunk`), and
    fixes every sum; ``bm``, ``micro`` = (tm, tn), ``stages``, ``steps``
    and ``group`` override the picks (for the sweep) and move no sum (in bf16 the
    tile edge follows m, :func:`tuning.mma_edge`).  A geometry the kernel
    is not built for (:data:`DENSE_TILES` and :data:`DENSE_RINGS`; rows,
    :data:`GATHERED_TILES` at :data:`DENSE_RING`; columns,
    :data:`COLS_BUILT`; bf16, :data:`MMA_BUILT`) raises."""
    if dtype not in DENSE_TILES and dtype != torch.bfloat16:
        raise TypeError(f"dense_tile is built for {tuple(DENSE_TILES)} and "
                        f"mma_tile for torch.bfloat16, not {dtype}")
    if source not in SOURCES:
        raise ValueError(f"source={source!r} is none of {SOURCES}")
    chunk = resolve_chunk(m, K, dtype, "cols" if source == "cols" else "rows",
                          bk)
    splits = -(-K // chunk)
    if splits > tuning.MAX_SPLITS:
        raise ValueError(f"{splits} splits exceed the grid's "
                         f"{tuning.MAX_SPLITS}")
    if dtype == torch.bfloat16:
        return _mma_geometry(m, chunk, splits, source, bm, micro, stages,
                             steps, group)
    if source == "cols":
        return _cols_geometry(m, chunk, splits, dtype, bm, micro, stages,
                              steps, group)
    tiles = DENSE_TILES[dtype]
    if bm is None:
        edges = [t[0] for t in tiles]
        fits = [e for e in edges
                if lower_tiles(m, e) * splits >= DENSE_TARGET_BLOCKS]
        bm = max(fits) if fits else min(edges)
    if micro is None:
        micro = next((t[1:] for t in tiles if t[0] == bm), (4, 4))
    tm, tn = micro
    stages = DENSE_RING[0] if stages is None else stages
    steps = DENSE_RING[1] if steps is None else steps
    group = DENSE_GROUP if group is None else group
    gathered = source == "rows"
    built = GATHERED_TILES[dtype] if gathered else tiles
    rings = (DENSE_RING,) if gathered else DENSE_RINGS[dtype]
    if (bm, tm, tn) not in built or (stages, steps) not in rings:
        raise ValueError(f"bm={bm}, micro={micro}, stages={stages}, "
                         f"steps={steps}: dense_tile is built in "
                         f"{str(dtype).split('.')[-1]} on {source} rows for "
                         f"tiles {built} and rings {rings}")
    return _geometry(m, chunk, splits, dtype, bm, tm, tn, stages, steps,
                     group, source)


def _geometry(m, chunk, splits, dtype, bm, tm, tn, stages, steps, group,
              source) -> DenseGeometry:
    if group < 1:
        raise ValueError(f"group={group} must be positive")
    smem = ring_bytes(bm, stages, steps, dtype)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{smem} bytes of shared memory exceed the block's "
                         f"{SMEM_PER_BLOCK}")
    return DenseGeometry(bm, tm, tn, stages, steps, (bm // tm) * (bm // tn),
                         (lower_tiles(m, bm), splits), smem, group, chunk,
                         splits, source)


def _cols_geometry(m, chunk, splits, dtype, bm, micro, stages, steps,
                   group) -> DenseGeometry:
    """K3's geometry at its chunk: the narrowest built tile edge that holds
    min(m, 32) panel rows, with its micro-tile and ring from
    :data:`COLS_BUILT`; any field may be overridden with another built
    one."""
    built = COLS_BUILT[dtype]
    if bm is None:
        edges = sorted({g[0] for g in built})
        bm = next((e for e in edges if e >= min(m, 32)), edges[-1])
    _, ptm, ptn, pst, pq = next((g for g in built if g[0] == bm),
                                (bm,) + (None,) * 4)
    tm, tn = (ptm, ptn) if micro is None else micro
    stages = pst if stages is None else stages
    steps = pq if steps is None else steps
    if (bm, tm, tn, stages, steps) not in built:
        raise ValueError(f"bm={bm}, micro={(tm, tn)}, stages={stages}, "
                         f"steps={steps}: dense_tile is built in "
                         f"{str(dtype).split('.')[-1]} on cols for "
                         f"(bm, tm, tn, stages, steps) in {built}")
    return _geometry(m, chunk, splits, dtype, bm, tm, tn, stages, steps,
                     DENSE_GROUP if group is None else group, "cols")


def _mma_geometry(m, chunk, splits, source, bm, micro, stages, steps,
                  group) -> DenseGeometry:
    """The bf16 packets' geometry (mma_tile) at their chunk: the tile edge
    tuning.mma_edge(m) with its ring from :data:`MMA_BUILT`; any field may
    be overridden with another built one."""
    built = MMA_BUILT[source]
    bm = tuning.mma_edge(m) if bm is None else bm
    tiles = lower_tiles(m, bm)
    _, pst, pq = next((g for g in built if g[0] == bm and mma_bytes(
        *g, source, tiles) <= SMEM_PER_BLOCK), (bm, None, None))
    stages = pst if stages is None else stages
    steps = pq if steps is None else steps
    micro = MMA_MICRO if micro is None else tuple(micro)
    if (bm, stages, steps) not in built or micro != MMA_MICRO:
        raise ValueError(f"bm={bm}, micro={micro}, stages={stages}, "
                         f"steps={steps}: mma_tile is built in bfloat16 on "
                         f"{source} for (bm, stages, steps) in {built} with "
                         f"micro-tile {MMA_MICRO}")
    group = DENSE_GROUP if group is None else group
    if group < 1:
        raise ValueError(f"group={group} must be positive")
    smem = mma_bytes(bm, stages, steps, source, tiles)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{smem} bytes of shared memory exceed the block's "
                         f"{SMEM_PER_BLOCK}")
    return DenseGeometry(bm, *MMA_MICRO, stages, steps, MMA_THREADS,
                         (tiles, splits), smem, group, chunk, splits, source)


def tile_order(nt: int, group: int) -> list[tuple[int, int]]:
    """The lower tiles (ti, tj), tj <= ti < nt, in launch order: strips of
    ``group`` row bands, and within a strip column by column, so that the
    blocks resident at one time share few row bands of A."""
    out = []
    for s0 in range(0, nt, group):
        s1 = min(s0 + group, nt)
        for tj in range(s1):
            out.extend((ti, tj) for ti in range(max(s0, tj), s1))
    return out


# Tile lists on the card, per (device index, nt, group).
_TILES: dict = {}


def dense_tiles(device: torch.device, nt: int, group: int) -> torch.Tensor:
    """:func:`tile_order` packed as ``ti << 16 | tj`` in an int32 tensor on
    ``device``, built once per (device, nt, group)."""
    key = (device.index, nt, group)
    if key not in _TILES:
        _TILES[key] = torch.tensor([ti << 16 | tj for ti, tj in
                                    tile_order(nt, group)],
                                   dtype=torch.int32, device=device)
    return _TILES[key]


def dense_buffers(m: int, geom: DenseGeometry, residual: bool,
                  **opts) -> tuple:
    """(G, r, Gp, rp) for a launch at ``geom``: the outputs G (m, m) and,
    with ``residual``, r (m,); at more than one split the chunk partials Gp
    (splits, mp, mp) and rp (splits, mp) that the reduce pass sums (mp: m
    rounded up to its 32-row tiles), at one split None: the kernel then
    writes G and r itself."""
    G = torch.empty((m, m), **opts)
    r = torch.empty((m,), **opts) if residual else None
    if geom.splits == 1:
        return G, r, None, None
    mp = -(-m // tuning.TILE) * tuning.TILE
    Gp = torch.empty((geom.splits, mp, mp), **opts)
    rp = torch.empty((geom.splits, mp), **opts) if residual else None
    return G, r, Gp, rp


def launch_dense(info: _build.KernelInfo, A: torch.Tensor,
                 u: torch.Tensor | None, geom: DenseGeometry, scale: float,
                 reg: float, scale_r: float | None,
                 flat: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Allocate the outputs (:func:`dense_buffers`), then launch, at
    ``geom``, K7 (``u`` given) or K8 on A, or with ``flat`` K1 on the rows
    ``A[flat]`` of A = X (``geom.source`` "rows") or K3 on its columns
    ``A[:, flat]`` ("cols").  Returns (G, r), r None for K8."""
    if (flat is None) != (geom.source == "dense"):
        raise ValueError(f"a {geom.source} geometry "
                         f"{'takes' if flat is None else 'takes no'} flat")
    if flat is None:
        m, K = A.shape
    else:
        m, K = flat.shape[0], A.shape[1 if geom.source == "rows" else 0]
    G, r, Gp, rp = dense_buffers(m, geom, u is not None,
                                 dtype=ref.acc_dtype(A.dtype),
                                 device=A.device)
    nt = -(-m // geom.bm)
    tiles = dense_tiles(A.device, nt, geom.group)

    def ptr(t):
        return None if t is None else t.data_ptr()

    sizes = (K, m, geom.chunk, geom.splits, geom.bm, geom.tm, geom.tn,
             geom.stages, geom.steps, geom.grid[0], geom.smem)
    scalars = (float(scale), float(reg))
    if u is not None:
        scalars += (float(scale if scale_r is None else scale_r),)
    suffix = PACKET_SUFFIX[A.dtype]
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        if u is None:
            fn = _build.bind("gram_dense.cu", f"dense_gram_{suffix}",
                             _GRAM_ARGS)
            err = fn(A.data_ptr(), tiles.data_ptr(), ptr(Gp), G.data_ptr(),
                     *sizes, *scalars, stream)
        else:
            outs = (tiles.data_ptr(), ptr(Gp), ptr(rp), G.data_ptr(),
                    r.data_ptr())
            if flat is None:
                fn = _build.bind("gram_dense.cu", f"dense_packet_{suffix}",
                                 _PACKET_ARGS)
                err = fn(A.data_ptr(), u.data_ptr(), *outs, *sizes,
                         *scalars, stream)
            elif geom.source == "rows":
                fn = _build.bind("sampled_rows.cu", f"rows_packet_{suffix}",
                                 _ROWS_PACKET_ARGS)
                err = fn(A.data_ptr(), flat.data_ptr(), u.data_ptr(), *outs,
                         *sizes, *scalars, stream)
            else:
                fn = _build.bind("sampled_cols.cu", f"cols_packet_{suffix}",
                                 _COLS_PACKET_ARGS)
                err = fn(A.data_ptr(), flat.data_ptr(), u.data_ptr(), *outs,
                         K, A.shape[1], *sizes[1:], *scalars, stream)
    _build.check(err, info.name)
    info.launches += 1
    return G, r


def _check_operand(A: torch.Tensor, what: str, *, bf16: bool = False
                   ) -> tuple[int, int]:
    check_matrix(A, what, bf16=bf16)
    if A.numel() == 0:
        raise ValueError(f"{what}: A must be non-empty, got shape "
                         f"{tuple(A.shape)}")
    return A.shape


def gram_packet_dense(A: torch.Tensor, u: torch.Tensor, *,
                      scale: float = 1.0, reg: float = 0.0,
                      scale_r: float | None = None, bk: int | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: the packet on a materialised A (m, K) and u (K,); A and u
    float32, float64 or bfloat16 (then G and r are float32)."""
    if A.device.type == "cpu":
        return ref.gram_packet_ref(A, u, scale, reg, scale_r)
    info = DENSE_PACKET_BF16 if A.dtype == torch.bfloat16 else DENSE_PACKET
    m, K = _check_operand(A, info.name, bf16=True)
    check_vector(A, u, K, info.name, name="u")
    return launch_dense(info, A, u, dense_geometry(m, K, A.dtype, bk),
                        scale, reg, scale_r)


def gram_dense(A: torch.Tensor, *, scale: float = 1.0, reg: float = 0.0,
               bk: int | None = None) -> torch.Tensor:
    """K8: G = scale * A A^T + reg * I for a materialised A (m, K)."""
    if A.device.type == "cpu":
        return ref.gram_ref(A, scale, reg)
    m, K = _check_operand(A, DENSE_GRAM.name)
    G, _ = launch_dense(DENSE_GRAM, A, None, dense_geometry(m, K, A.dtype, bk),
                        scale, reg, None)
    return G
