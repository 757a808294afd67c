"""Wrappers of the row-sampled CUDA kernels K1, K2 and K6
(``csrc/sampled_rows.cu``).

* :func:`gram_packet_sampled_rows` (K1) -- ``(G, r) = (scale * Y Y^T +
  reg * I, scale_r * Y u)`` for ``Y = X[flat, :]``.  Replaces
  ``gram_packet_sampled_pallas`` (``src/repro/kernels/gram/
  sampled_kernel.py``).  Bounded on the H100 by its m(m+1)/2 * n
  multiply-adds on the f32 CUDA cores at the solve's m = 128.  It runs the
  dense Gram tile (``csrc/dense_tile.cuh``) on the rows ``X[flat]`` in
  place, at K7's geometry for the same (m, n) (:func:`rows_packet_geometry`,
  ``gram_kernel.launch_dense``), so it equals K7 on the gathered panel bit
  for bit.  It also takes bf16 X and u, as the reference's kernel does:
  bf16 products with f32 sums on the tensor cores (``mma_tile``, its own
  geometry and chunk), f32 (G, r), equal to K7's on the gathered rows bit
  for bit (counted apart, :data:`ROWS_PACKET_BF16`).
* :func:`panel_apply_rows` (K2) -- ``out(n) = scale * Y^T v``.  Replaces
  ``panel_apply_pallas`` (same file).  Bounded by the m * n bytes of X it
  reads.  One thread per column sums one chain in sample order, with two
  batches of loads in flight; narrow blocks keep every block resident.  The
  geometry comes from :func:`apply_geometry` and moves no sum.
* :func:`panel_matvec_rows` (K6) -- ``out = scale * Y t`` for t (n,) or T
  tenant vectors (T, n).  Replaces ``panel_matvec_pallas`` (same file).
  Sums in K1's residual order, so it equals K1's r bit for bit at the same
  chunk; bounded by the m * n bytes of the sampled rows plus t's T * n.
  Each block streams a few sample rows through a shared-memory ring filled
  by ``cp.async``, so that loads stay in flight while it sums, and the last
  block of each row group sums the chunks; the launch geometry comes from
  :func:`matvec_geometry`.  Near the bytes bound at CG's shape; at the
  solve's m = 128 each block's fixed chain of round trips is what is left.

Each wrapper runs the plain version (``ref.py``) when ``X`` lies on the CPU,
and on a CUDA tensor launches its kernel or raises: there is no fallback.
Each kernel has a :class:`~._build.KernelInfo` whose ``launches`` counts its
launches.  The wrappers never pad ``X``: the kernels mask ragged edges.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build, ref, tuning

ROWS_PACKET = _build.KernelInfo(
    "gram_packet_sampled_rows", "src/repro_torch/csrc/sampled_rows.cu",
    "src/repro/kernels/gram/sampled_kernel.py:136")
ROWS_PACKET_BF16 = _build.KernelInfo(
    "gram_packet_sampled_rows_bf16", "src/repro_torch/csrc/sampled_rows.cu",
    "src/repro/kernels/gram/sampled_kernel.py:136")
ROWS_APPLY = _build.KernelInfo(
    "panel_apply_rows", "src/repro_torch/csrc/sampled_rows.cu",
    "src/repro/kernels/gram/sampled_kernel.py:209")
ROWS_MATVEC = _build.KernelInfo(
    "panel_matvec_rows", "src/repro_torch/csrc/sampled_rows.cu",
    "src/repro/kernels/gram/sampled_kernel.py:261")

P, I, I64, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
# rows_apply_*(X, flat, v, out, n, m, threads, cols, batch, scale, stream);
# rows_matvec_*(X, flat, t, rp, tickets, out, n, m, tenants, chunk, splits,
#               rows, group, stages, steps, grid_x, smem, scale, stream);
# rows_packet_* in gram_kernel.py
_APPLY_ARGS = (P, P, P, P, I64, I, I, I, I, D, P)
MATVEC_ARGS = (P,) * 6 + (I64, I, I, I64, I, I, I, I, I, I, I, D, P)
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# The packets K1, K3 and K7 also take bf16 (f32 sums and outputs).
PACKET_SUFFIX = SUFFIX | {torch.bfloat16: "bf16"}

# K2 (rows_apply): the block sizes, and per dtype the (columns a thread,
# batch) pairs it is built for (a batch: the samples whose loads a thread
# keeps in flight, two batches at a time), and the picks from
# launch.tile_sweep's apply sweep (PERF.md): (threads, cols, batch) at CG's
# shape, where 64-thread blocks kept in step by the window barrier read X
# best; and the threads where m fits one 32-sample window (the solve's
# m = 8), where no barrier runs and fewer, wider blocks take less time.
# The batch is cut to the smallest built one that covers m, else the
# largest built.
APPLY_THREADS = (64, 128, 256)
APPLY_BUILT = {torch.float32: ((1, 8), (2, 4), (2, 8), (2, 16), (4, 8)),
               torch.float64: ((1, 8), (2, 4), (2, 8))}
APPLY_PICK = (64, 2, 16)
APPLY_WINDOW_THREADS = 256

# The matvec ring kernel (csrc/gram_common.cuh, matvec_ring): its block size,
# and the rows per block, ring depths and stage lengths (contraction steps)
# it is built for.  A stage row holds its steps plus one 16-byte chunk.
MV_THREADS = 128
MV_ROWS = (4, 8, 16, 32)
MV_STAGES = (2, 3, 4)
MV_STEPS = (64, 128, 256)
# The picks, from launch.tile_sweep's matvec sweep (PERF.md): the most rows
# per block that keep at most MV_OWNERS summing threads (beyond that, at
# T = 8, the block's shared-memory loads bound it) and still give
# MV_TARGET_BLOCKS blocks, else the fewest rows; and per layout the ring
# depth and stage length, (stages, steps).
MV_OWNERS = 64
MV_TARGET_BLOCKS = 4 * 132
MV_PICK = {"rows": (2, 128), "cols": (2, 64)}
SMEM_PER_BLOCK = 232448         # bytes of shared memory a block may use


def check_matrix(X: torch.Tensor, what: str, *, bf16: bool = False) -> None:
    """The operand a kernel reads: float32 or float64 (and bfloat16 where
    ``bf16``: the packets K1, K3 and K7), 2-D and contiguous (the wrappers never
    copy it)."""
    if X.dtype not in (PACKET_SUFFIX if bf16 else SUFFIX):
        hint = (f" (bf16 input is taken by the packets K1, K3 and K7 only; "
                f"{what} has no bf16 build)"
                if X.dtype == torch.bfloat16 else "")
        raise TypeError(f"{what}: X dtype {X.dtype} not in float32/float64"
                        + hint)
    if X.dim() != 2 or not X.is_contiguous():
        raise ValueError(f"{what}: X must be a contiguous 2-D tensor, got "
                         f"shape {tuple(X.shape)} strides {X.stride()}")


def check_vector(X: torch.Tensor, vec: torch.Tensor, vec_len: int,
                 what: str, *, name: str = "vector",
                 dims: tuple = (1,)) -> None:
    """A contiguous, non-empty vector (or ``dims``-D stack of vectors) of
    ``vec_len`` elements, on X's device and of X's dtype."""
    _check_placement(X, vec, name, dims, what)
    if vec.dtype != X.dtype:
        raise TypeError(f"{what}: {name} dtype {vec.dtype} != X dtype "
                        f"{X.dtype}")
    if vec.shape[-1] != vec_len:
        raise ValueError(f"{what}: {name} length {vec.shape[-1]} != "
                         f"{vec_len}")


def _check_placement(X, t, name, dims, what) -> None:
    if t.device != X.device:
        raise ValueError(f"{what}: {name} on {t.device}, X on {X.device}")
    if t.dim() not in dims or not t.is_contiguous() or t.numel() == 0:
        raise ValueError(f"{what}: {name} must be a contiguous, "
                         f"non-empty {' or '.join(map(str, dims))}-D "
                         f"tensor, got shape {tuple(t.shape)}")


def check_cuda_operands(X: torch.Tensor, flat: torch.Tensor,
                        vec: torch.Tensor, vec_len: int, n_index: int,
                        what: str, *, tenants: bool = False,
                        bf16: bool = False) -> None:
    """Everything a kernel takes on trust, checked before the launch: device,
    dtype, contiguity, shapes and the index range ``0 <= flat < n_index``.
    ``tenants`` lets the vector carry a leading tenant axis, (T, vec_len);
    ``bf16`` admits a bfloat16 X (and vector)."""
    check_matrix(X, what, bf16=bf16)
    _check_placement(X, flat, "flat", (1,), what)
    check_vector(X, vec, vec_len, what, dims=(1, 2) if tenants else (1,))
    if flat.dtype != torch.int32:
        raise TypeError(f"{what}: flat must be int32, got {flat.dtype}")
    lo, hi = torch.stack(torch.aminmax(flat)).tolist()   # one device sync
    if lo < 0 or hi >= n_index:
        raise IndexError(f"{what}: flat spans [{lo}, {hi}], outside "
                         f"[0, {n_index})")


def resolve_chunk(m: int, K: int, dtype: torch.dtype, layout: str,
                  bk: int | None) -> int:
    """An explicit chunk wins over the tuning pick; it must be a multiple of
    the 32-step shared-memory stage."""
    bk = tuning.pick_tiles(m, K, dtype, layout) if bk is None else bk
    if bk % tuning.BK:
        raise ValueError(f"bk={bk} must be a multiple of {tuning.BK}")
    return bk


class ApplyGeometry(NamedTuple):
    """How a K2 launch is cut: ``threads`` threads a block, ``cols``
    columns a thread (32 apart), ``batch`` samples a load batch, and
    ``blocks`` blocks."""
    threads: int
    cols: int
    batch: int
    blocks: int


def apply_geometry(m: int, n: int, dtype: torch.dtype, *,
                   threads: int | None = None, cols: int | None = None,
                   batch: int | None = None) -> ApplyGeometry:
    """The launch geometry of K2 over m samples of rows of n columns, from
    the shapes alone: the pick (:data:`APPLY_WINDOW_THREADS` threads where
    m <= 32), its batch the smallest built one (at the picked cols) that
    covers min(m, picked batch), else the largest built; ``threads``,
    ``cols`` and ``batch`` override it (for the sweep).  Every column is one
    chain in sample order whatever the geometry."""
    if dtype not in APPLY_BUILT:
        raise TypeError(f"rows_apply is built for {tuple(APPLY_BUILT)}, "
                        f"not {dtype}")
    if not 1 <= n < 2**31:
        raise ValueError(f"rows_apply takes 1 <= n < 2**31 columns, got {n}")
    built = APPLY_BUILT[dtype]
    if threads is None:
        threads = APPLY_WINDOW_THREADS if m <= 32 else APPLY_PICK[0]
    cols = APPLY_PICK[1] if cols is None else cols
    qs = sorted(q for c, q in built if c == cols)
    if batch is None and qs:
        batch = next((q for q in qs if q >= min(m, APPLY_PICK[2])), qs[-1])
    if threads not in APPLY_THREADS or (cols, batch) not in built:
        raise ValueError(f"threads={threads}, cols={cols}, batch={batch}: "
                         f"rows_apply is built for threads in "
                         f"{APPLY_THREADS} and (cols, batch) in {built} in "
                         f"{str(dtype).split('.')[-1]}")
    return ApplyGeometry(threads, cols, batch, -(-n // (threads * cols)))


def launch_apply(X: torch.Tensor, flat: torch.Tensor, v: torch.Tensor,
                 geom: ApplyGeometry, scale: float) -> torch.Tensor:
    """Allocate the output and launch K2 at ``geom``:
    ``rows_apply_{f32,f64}(X, flat, v, out, n, m, threads, cols, batch,
    scale, stream)``."""
    n = X.shape[1]
    out = torch.empty((n,), dtype=X.dtype, device=X.device)
    fn = _build.bind("sampled_rows.cu", f"rows_apply_{SUFFIX[X.dtype]}",
                     _APPLY_ARGS)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(X.data_ptr(), flat.data_ptr(), v.data_ptr(), out.data_ptr(),
                 n, flat.shape[0], geom.threads, geom.cols, geom.batch,
                 float(scale), stream)
    _build.check(err, ROWS_APPLY.name)
    ROWS_APPLY.launches += 1
    return out


class MatvecGeometry(NamedTuple):
    """How a matvec launch is cut: ``rows`` sample rows and ``group``
    tenants per block, a ring of ``stages`` stages of ``steps``
    contraction steps, ``threads`` per block,
    ``grid`` = (row groups x tenant groups, splits), ``smem`` bytes of
    dynamic shared memory, and the contraction ``chunk`` with its
    ``splits``."""
    rows: int
    group: int
    stages: int
    steps: int
    threads: int
    grid: tuple
    smem: int
    chunk: int
    splits: int


def matvec_geometry(m: int, K: int, tenants: int, dtype: torch.dtype,
                    layout: str, bk: int | None = None, *,
                    rows: int | None = None, stages: int | None = None,
                    steps: int | None = None) -> MatvecGeometry:
    """The launch geometry of K5 / K6 for ``tenants`` vectors over an
    (m samples, K contraction) panel, from the shapes alone.  The chunk is
    the packet's (:func:`resolve_chunk`), which fixes every sum; rows per
    block, ring depth and stage length only cut the work (``rows``,
    ``stages`` and ``steps`` override the picks, for the sweep).  Built in
    float32 and float64 only."""
    if dtype not in SUFFIX:
        raise TypeError(f"the matvecs K5 / K6 (matvec_ring) are built for "
                        f"float32 / float64, not {dtype}")
    chunk = resolve_chunk(m, K, dtype, layout, bk)
    splits = -(-K // chunk)
    if splits > tuning.MAX_SPLITS:
        raise ValueError(f"{splits} splits exceed the grid's "
                         f"{tuning.MAX_SPLITS}")

    def group(r):
        return min(tenants, MV_THREADS // r)

    def grid_x(r):
        return -(-m // r) * -(-tenants // group(r))

    if rows is None:
        fits = [r for r in MV_ROWS if r * group(r) <= MV_OWNERS
                and grid_x(r) * splits >= MV_TARGET_BLOCKS]
        rows = max(fits) if fits else min(MV_ROWS)
    stages = MV_PICK[layout][0] if stages is None else stages
    steps = MV_PICK[layout][1] if steps is None else steps
    if (rows not in MV_ROWS or stages not in MV_STAGES
            or steps not in MV_STEPS):
        raise ValueError(f"rows={rows}, stages={stages}, steps={steps}: the "
                         f"kernel is built for rows in {MV_ROWS}, stages in "
                         f"{MV_STAGES}, steps in {MV_STEPS}")
    isz = torch.empty((), dtype=dtype).element_size()
    ld = steps + 16 // isz
    smem = (16 * -(-4 * (2 * rows + group(rows)) // 16)
            + stages * (rows + group(rows)) * ld * isz)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"rows={rows}, stages={stages}, steps={steps}: "
                         f"{smem} bytes of shared memory exceed the block's "
                         f"{SMEM_PER_BLOCK}")
    return MatvecGeometry(rows, group(rows), stages, steps, MV_THREADS,
                          (grid_x(rows), splits), smem, chunk, splits)


# Ticket counters of the matvec kernel, per (device, stream): zero between
# launches, so that a launch needs no fill kernel of its own.
_TICKETS: dict = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least n int32 zeros on ``device`` for the matvec kernel's ticket
    counters, kept per (device, stream): each launch leaves them zero again
    (the last block of a row group resets its own), so only a first or a
    larger launch allocates."""
    key = (device.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


def launch_matvec(info: _build.KernelInfo, symbol: str, argtypes: tuple,
                  X: torch.Tensor, flat: torch.Tensor, t: torch.Tensor,
                  sizes: tuple, geom: MatvecGeometry,
                  scale: float) -> torch.Tensor:
    """Allocate the output and the split partials, then launch a matvec
    kernel: ``symbol_{f32,f64}(X, flat, t, rp, tickets, out, *sizes, m,
    tenants, chunk, splits, rows, group, stages, steps, grid_x, smem, scale,
    stream)``.  Returns (m,) for t (K,), (T, m) for t (T, K)."""
    m = flat.shape[0]
    tenants = 1 if t.dim() == 1 else t.shape[0]
    mp = -(-m // tuning.TILE) * tuning.TILE
    opts = {"dtype": X.dtype, "device": X.device}
    out = torch.empty((tenants, m), **opts)
    rp = torch.empty((geom.splits, tenants, mp), **opts)
    fn = _build.bind(info.source.split("/")[-1], f"{symbol}_{SUFFIX[X.dtype]}",
                     argtypes)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        tickets = _tickets(X.device, stream, geom.grid[0])
        err = fn(X.data_ptr(), flat.data_ptr(), t.data_ptr(), rp.data_ptr(),
                 tickets.data_ptr(), out.data_ptr(), *sizes, m, tenants,
                 geom.chunk, geom.splits, geom.rows, geom.group, geom.stages,
                 geom.steps, geom.grid[0], geom.smem, float(scale), stream)
    _build.check(err, info.name)
    info.launches += 1
    return out if t.dim() == 2 else out[0]


def rows_packet_geometry(m: int, n: int, dtype: torch.dtype,
                         bk: int | None = None, **over):
    """K1's launch geometry over m rows of X (d, n): the dense tile's pick
    for (m, n) at K1's chunk (``gram_kernel.dense_geometry`` with ``source``
    "rows"); ``over`` overrides it as there (for the tests)."""
    from .gram_kernel import dense_geometry   # gram_kernel imports this module
    return dense_geometry(m, n, dtype, bk, source="rows", **over)


def gram_packet_sampled_rows(X: torch.Tensor, flat: torch.Tensor,
                             u: torch.Tensor, *, scale: float = 1.0,
                             reg: float = 0.0, scale_r: float | None = None,
                             bk: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: the row-sampled packet for X (d, n), flat (m,) int32, u (n,);
    X and u float32, float64 or bfloat16 (then G and r are float32)."""
    if X.device.type == "cpu":
        return ref.gram_packet_sampled_ref(X, flat, u, scale, reg, scale_r)
    from .gram_kernel import launch_dense
    d, n = X.shape
    info = ROWS_PACKET_BF16 if X.dtype == torch.bfloat16 else ROWS_PACKET
    check_cuda_operands(X, flat, u, n, d, info.name, bf16=True)
    geom = rows_packet_geometry(flat.shape[0], n, X.dtype, bk)
    return launch_dense(info, X, u, geom, scale, reg, scale_r, flat)


def panel_apply_rows(X: torch.Tensor, flat: torch.Tensor, v: torch.Tensor,
                     *, scale: float = 1.0) -> torch.Tensor:
    """K2: out(n) = scale * X[flat, :]^T v for X (d, n), flat (m,), v (m,)."""
    if X.device.type == "cpu":
        return ref.panel_apply_ref(X, flat, v, scale)
    d, n = X.shape
    check_cuda_operands(X, flat, v, flat.shape[0], d, ROWS_APPLY.name)
    return launch_apply(X, flat, v, apply_geometry(flat.shape[0], n, X.dtype),
                        scale)


def panel_matvec_rows(X: torch.Tensor, flat: torch.Tensor, t: torch.Tensor,
                      *, scale: float = 1.0, bk: int | None = None
                      ) -> torch.Tensor:
    """K6: out = scale * X[flat, :] t for X (d, n), flat (m,), t (n,) -> (m,)
    or t (T, n) -> (T, m).  ``bk`` is the contraction chunk; at the packet's
    chunk (the default pick for the same m) the sums equal K1's r."""
    if X.device.type == "cpu":
        return ref.panel_matvec_ref(X, flat, t, scale)
    d, n = X.shape
    check_cuda_operands(X, flat, t, n, d, ROWS_MATVEC.name, tenants=True)
    geom = matvec_geometry(flat.shape[0], n, 1 if t.dim() == 1 else
                           t.shape[0], X.dtype, "rows", bk)
    return launch_matvec(ROWS_MATVEC, "rows_matvec", MATVEC_ARGS, X, flat, t,
                         (n,), geom, scale)
