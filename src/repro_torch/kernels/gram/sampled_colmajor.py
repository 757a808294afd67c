"""Wrappers of the column-sampled CUDA kernels K3 and K4
(``csrc/sampled_cols.cu``): the dual's operand read in X's original (d, n)
layout, with no transposed copy of X.

* :func:`gram_packet_sampled_cols` (K3) -- ``(G, r) = (scale * Y^T Y +
  reg * I, scale_r * Y^T u)`` for ``Y = X[:, flat]``, contracted over d.
  Replaces ``gram_packet_sampled_cols_pallas`` (``src/repro/kernels/gram/
  sampled_colmajor.py``).  Each sampled element is a scattered read, one
  32-byte sector per element: that sector traffic bounds it on the H100.
  The d-contraction is split over blocks as in K1.
* :func:`panel_apply_cols` (K4) -- ``out(d) = scale * Y v``.  Replaces
  ``panel_apply_cols_pallas`` (same file).  One warp per row of X, also
  bounded by the sector traffic of its scattered reads.
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

import torch

from . import _build, ref
from .sampled_kernel import (D, I, I64, P, SUFFIX, check_cuda_operands,
                             launch_matvec, launch_packet, matvec_geometry,
                             resolve_chunk)

COLS_PACKET = _build.KernelInfo(
    "gram_packet_sampled_cols", "src/repro_torch/csrc/sampled_cols.cu",
    "src/repro/kernels/gram/sampled_colmajor.py:143")
COLS_APPLY = _build.KernelInfo(
    "panel_apply_cols", "src/repro_torch/csrc/sampled_cols.cu",
    "src/repro/kernels/gram/sampled_colmajor.py:280")
COLS_MATVEC = _build.KernelInfo(
    "panel_matvec_cols", "src/repro_torch/csrc/sampled_cols.cu",
    "src/repro/kernels/gram/sampled_colmajor.py:224")

# cols_packet_*(X, flat, u, Gp, rp, G, r, d, n, m, chunk, splits, scale, reg,
#               scale_r, stream); cols_apply_*(X, flat, v, out, d, n, m,
#               scale, stream); cols_matvec_*(X, flat, t, rp, tickets, out,
#               d, n, m, tenants, chunk, splits, rows, group, stages, steps,
#               grid_x, smem, scale, stream)
_PACKET_ARGS = (P,) * 7 + (I64, I64, I, I64, I, D, D, D, P)
_APPLY_ARGS = (P, P, P, P, I64, I64, I, D, P)
MATVEC_ARGS = (P,) * 6 + (I64, I64, I, I, I64, I, I, I, I, I, I, I, D, P)


def gram_packet_sampled_cols(X: torch.Tensor, flat: torch.Tensor,
                             u: torch.Tensor, *, scale: float = 1.0,
                             reg: float = 0.0, scale_r: float | None = None,
                             bk: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: the column-sampled packet for X (d, n), flat (m,) int32 over n,
    u (d,)."""
    if X.device.type == "cpu":
        return ref.gram_packet_sampled_cols_ref(X, flat, u, scale, reg,
                                                scale_r)
    d, n = X.shape
    check_cuda_operands(X, flat, u, d, n, COLS_PACKET.name)
    chunk = resolve_chunk(flat.shape[0], d, X.dtype, "cols", bk)
    return launch_packet(COLS_PACKET, "cols_packet", _PACKET_ARGS,
                         (X, flat, u), (d, n), flat.shape[0], d, chunk, scale,
                         reg, scale if scale_r is None else scale_r)


def panel_apply_cols(X: torch.Tensor, flat: torch.Tensor, v: torch.Tensor,
                     *, scale: float = 1.0) -> torch.Tensor:
    """K4: out(d) = scale * X[:, flat] @ v for X (d, n), flat (m,), v (m,)."""
    if X.device.type == "cpu":
        return ref.panel_apply_cols_ref(X, flat, v, scale)
    d, n = X.shape
    check_cuda_operands(X, flat, v, flat.shape[0], n, COLS_APPLY.name)
    out = torch.empty((d,), dtype=X.dtype, device=X.device)
    fn = _build.bind("sampled_cols.cu", f"cols_apply_{SUFFIX[X.dtype]}",
                     _APPLY_ARGS)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(X.data_ptr(), flat.data_ptr(), v.data_ptr(), out.data_ptr(),
                 d, n, flat.shape[0], float(scale), stream)
    _build.check(err, COLS_APPLY.name)
    COLS_APPLY.launches += 1
    return out


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
