"""Wrappers of the column-sampled CUDA kernels K3, K4 and K5
(``csrc/sampled_cols.cu``): the dual's operand read in X's original (d, n)
layout, with no transposed copy of X.

* :func:`gram_packet_sampled_cols` (K3) -- ``(G, r) = (scale * Y^T Y +
  reg * I, scale_r * Y^T u)`` for ``Y = X[:, flat]``, contracted over d.
  Replaces ``gram_packet_sampled_cols_pallas`` (``src/repro/kernels/gram/
  sampled_colmajor.py``).  Each sampled element is a scattered read, one
  32-byte sector per element: that sector traffic bounds it on the H100.
  It runs the dense Gram tile (``csrc/dense_tile.cuh``) on the columns
  ``X[:, flat]`` in place, at K3's own chunk and the shallow rings that
  read best in ``launch.tile_sweep``'s cols sweep
  (:func:`cols_packet_geometry`, ``gram_kernel.launch_dense``), so it
  equals K7 on the gathered panel ``X[:, flat].T`` at that chunk bit for
  bit.  It also takes bf16 X and u, as the reference's kernel does:
  bf16 products with f32 sums on the tensor cores (``mma_tile``, its own
  geometry and chunk: one 128-tile reads each sampled element once), f32
  (G, r), equal to bf16 K7 on ``X[:, flat].T`` at K3's chunk bit for bit
  (counted apart, :data:`COLS_PACKET_BF16`).
* :func:`panel_apply_cols` (K4) -- ``out(d) = scale * Y v``.  Replaces
  ``panel_apply_cols_pallas`` (same file).  Bounded by the sector traffic
  of its scattered reads.  Each row of X gets a segment of lanes as wide as
  m needs (up to a warp); each lane reads its samples' indices and weights
  once for its row and issues the loads of X before any multiply-add.  The
  geometry comes from :func:`apply_cols_geometry` and moves no sum.
* :func:`panel_matvec_cols` (K5) -- ``out = scale * Y^T t`` for t (d,) or
  T tenant vectors (T, d).  Replaces ``panel_matvec_cols_pallas`` (same
  file).  Sums in K3's residual order, so it equals K3's r bit for bit at
  the same chunk; bounded by the sector traffic of the sampled columns,
  which K6's ring kernel keeps in flight (one ``cp.async`` per element).
  What holds it back is the rate at which the memory serves isolated
  elements: PyTorch's gather of the same elements is slower than K5.

CPU tensors take the plain versions in ``ref.py``; CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build, ref
from .gram_kernel import dense_geometry, launch_dense
from .sampled_kernel import (D, I, I64, P, SUFFIX, check_cuda_operands,
                             launch_matvec, matvec_geometry)

COLS_PACKET = _build.KernelInfo(
    "gram_packet_sampled_cols", "src/repro_torch/csrc/sampled_cols.cu",
    "src/repro/kernels/gram/sampled_colmajor.py:143")
COLS_PACKET_BF16 = _build.KernelInfo(
    "gram_packet_sampled_cols_bf16", "src/repro_torch/csrc/sampled_cols.cu",
    "src/repro/kernels/gram/sampled_colmajor.py:143")
COLS_APPLY = _build.KernelInfo(
    "panel_apply_cols", "src/repro_torch/csrc/sampled_cols.cu",
    "src/repro/kernels/gram/sampled_colmajor.py:280")
COLS_MATVEC = _build.KernelInfo(
    "panel_matvec_cols", "src/repro_torch/csrc/sampled_cols.cu",
    "src/repro/kernels/gram/sampled_colmajor.py:224")

# cols_apply_*(X, flat, v, out, d, n, m, threads, seg, scale, stream);
# cols_matvec_*(X, flat, t, rp, tickets, out, d, n, m, tenants, chunk,
#               splits, rows, group, stages, steps, grid_x, smem, scale,
#               stream); cols_packet_* in gram_kernel.py
_APPLY_ARGS = (P, P, P, P, I64, I64, I, I, I, D, P)
MATVEC_ARGS = (P,) * 6 + (I64, I64, I, I, I64, I, I, I, I, I, I, I, D, P)

# K4 (cols_apply): its block size, and the lanes a row (segment widths) it
# is built for.  The pick: the narrowest segment of at least min(m, 32)
# lanes (one lane per sample residue mod 32); at the solve's m = 8 its 655
# blocks are one resident wave.
APPLY_COLS_THREADS = 256
APPLY_COLS_SEGS = (1, 2, 4, 8, 16, 32)


class ApplyColsGeometry(NamedTuple):
    """How a K4 launch is cut: ``threads`` threads a block, ``seg`` lanes a
    row of X (one row a segment), and ``blocks`` blocks."""
    threads: int
    seg: int
    blocks: int


def apply_cols_geometry(m: int, d: int, dtype: torch.dtype, *,
                        seg: int | None = None) -> ApplyColsGeometry:
    """The launch geometry of K4 over m samples of columns of X (d, n), from
    the shapes alone: segments of the smallest power of two >= min(m, 32)
    lanes; ``seg`` overrides the pick (for the sweep and the tests).  Every
    row's sum is the same whatever the segment; one narrower than
    min(m, 32) would drop samples and is refused."""
    if dtype not in SUFFIX:
        raise TypeError(f"cols_apply is built for {tuple(SUFFIX)}, not "
                        f"{dtype}")
    if m < 1 or d < 1:
        raise ValueError(f"cols_apply takes m >= 1 samples and d >= 1 rows, "
                         f"got m={m}, d={d}")
    need = min(m, 32)
    if seg is None:
        seg = next(w for w in APPLY_COLS_SEGS if w >= need)
    if seg not in APPLY_COLS_SEGS or seg < need:
        raise ValueError(f"seg={seg}: cols_apply is built for segments in "
                         f"{APPLY_COLS_SEGS} of at least min(m, 32) = {need} "
                         f"lanes")
    blocks = -(-d // (APPLY_COLS_THREADS // seg))
    if blocks >= 2**31:
        raise ValueError(f"d={d}: {blocks} blocks exceed the grid")
    return ApplyColsGeometry(APPLY_COLS_THREADS, seg, blocks)


def launch_apply_cols(X: torch.Tensor, flat: torch.Tensor, v: torch.Tensor,
                      geom: ApplyColsGeometry, scale: float) -> torch.Tensor:
    """Allocate the output and launch K4 at ``geom``:
    ``cols_apply_{f32,f64}(X, flat, v, out, d, n, m, threads, seg, scale,
    stream)``."""
    d, n = X.shape
    out = torch.empty((d,), dtype=X.dtype, device=X.device)
    fn = _build.bind("sampled_cols.cu", f"cols_apply_{SUFFIX[X.dtype]}",
                     _APPLY_ARGS)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(X.data_ptr(), flat.data_ptr(), v.data_ptr(), out.data_ptr(),
                 d, n, flat.shape[0], geom.threads, geom.seg, float(scale),
                 stream)
    _build.check(err, COLS_APPLY.name)
    COLS_APPLY.launches += 1
    return out


def cols_packet_geometry(m: int, d: int, dtype: torch.dtype,
                         bk: int | None = None, **over):
    """K3's launch geometry over m columns of X (d, n): the dense tile's
    pick at K3's own chunk (``resolve_chunk(m, d, dtype, "cols", bk)``)
    among the gathered-column tiles and rings it is built for
    (``gram_kernel.dense_geometry`` with ``source`` "cols"); ``over``
    overrides it as there (for the sweep and the tests)."""
    return dense_geometry(m, d, dtype, bk, source="cols", **over)


def gram_packet_sampled_cols(X: torch.Tensor, flat: torch.Tensor,
                             u: torch.Tensor, *, scale: float = 1.0,
                             reg: float = 0.0, scale_r: float | None = None,
                             bk: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: the column-sampled packet for X (d, n), flat (m,) int32 over n,
    u (d,); X and u float32, float64 or bfloat16 (then G and r are
    float32)."""
    if X.device.type == "cpu":
        return ref.gram_packet_sampled_cols_ref(X, flat, u, scale, reg,
                                                scale_r)
    d, n = X.shape
    info = COLS_PACKET_BF16 if X.dtype == torch.bfloat16 else COLS_PACKET
    check_cuda_operands(X, flat, u, d, n, info.name, bf16=True)
    geom = cols_packet_geometry(flat.shape[0], d, X.dtype, bk)
    return launch_dense(info, X, u, geom, scale, reg, scale_r, flat)


def panel_apply_cols(X: torch.Tensor, flat: torch.Tensor, v: torch.Tensor,
                     *, scale: float = 1.0) -> torch.Tensor:
    """K4: out(d) = scale * X[:, flat] @ v for X (d, n), flat (m,), v (m,)."""
    if X.device.type == "cpu":
        return ref.panel_apply_cols_ref(X, flat, v, scale)
    d, n = X.shape
    check_cuda_operands(X, flat, v, flat.shape[0], n, COLS_APPLY.name)
    return launch_apply_cols(
        X, flat, v, apply_cols_geometry(flat.shape[0], d, X.dtype), scale)


def panel_matvec_cols(X: torch.Tensor, flat: torch.Tensor, t: torch.Tensor,
                      *, scale: float = 1.0, bk: int | None = None
                      ) -> torch.Tensor:
    """K5: out = scale * X[:, flat]^T t for X (d, n), flat (m,) over n,
    t (d,) -> (m,) or t (T, d) -> (T, m).  At the packet's chunk the sums
    equal K3's r."""
    if X.device.type == "cpu":
        return ref.panel_matvec_cols_ref(X, flat, t, scale)
    d, n = X.shape
    check_cuda_operands(X, flat, t, d, n, COLS_MATVEC.name, tenants=True)
    geom = matvec_geometry(flat.shape[0], d, 1 if t.dim() == 1 else
                           t.shape[0], X.dtype, "cols", bk)
    return launch_matvec(COLS_MATVEC, "cols_matvec", MATVEC_ARGS, X, flat, t,
                         (d, n), geom, scale)
