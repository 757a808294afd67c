"""Wrappers of the row-sampled CUDA kernels K1 and K2 (``csrc/sampled_rows.cu``).

* :func:`gram_packet_sampled_rows` (K1) -- ``(G, r) = (scale * Y Y^T +
  reg * I, scale_r * Y u)`` for ``Y = X[flat, :]``.  Replaces
  ``gram_packet_sampled_pallas`` (``src/repro/kernels/gram/
  sampled_kernel.py``).  Bounded on the H100 by its m(m+1)/2 * n
  multiply-adds on the f32 CUDA cores at the solve's m = 128; the
  contraction is split over blocks to fill the card, the upper tiles are
  skipped and mirrored in the second pass.
* :func:`panel_apply_rows` (K2) -- ``out(n) = scale * Y^T v``.  Replaces
  ``panel_apply_pallas`` (same file).  Bounded by the m * n bytes of X it
  reads; one thread per column keeps every read coalesced.
* :func:`panel_matvec_rows` (K6) -- ``out = scale * Y t`` for t (n,) or T
  tenant vectors (T, n).  Replaces ``panel_matvec_pallas`` (same file).
  Sums in K1's residual order, so it equals K1's r bit for bit at the same
  chunk; bounded by the m * n bytes of the sampled rows plus t's T * n.

Each wrapper runs the plain version (``ref.py``) when ``X`` lies on the CPU,
and on a CUDA tensor launches its kernel or raises: there is no fallback.
Each kernel has a :class:`~._build.KernelInfo` whose ``launches`` counts its
launches.  The wrappers never pad ``X``: the kernels mask ragged edges.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref, tuning

ROWS_PACKET = _build.KernelInfo(
    "gram_packet_sampled_rows", "src/repro_torch/csrc/sampled_rows.cu",
    "src/repro/kernels/gram/sampled_kernel.py:136")
ROWS_APPLY = _build.KernelInfo(
    "panel_apply_rows", "src/repro_torch/csrc/sampled_rows.cu",
    "src/repro/kernels/gram/sampled_kernel.py:209")
ROWS_MATVEC = _build.KernelInfo(
    "panel_matvec_rows", "src/repro_torch/csrc/sampled_rows.cu",
    "src/repro/kernels/gram/sampled_kernel.py:261")

P, I, I64, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
# rows_packet_*(X, flat, u, Gp, rp, G, r, n, m, chunk, splits, scale, reg,
#               scale_r, stream); rows_apply_*(X, flat, v, out, n, m, scale,
#               stream); rows_matvec_*(X, flat, t, rp, out, n, m, tenants,
#               chunk, splits, scale, stream)
_PACKET_ARGS = (P,) * 7 + (I64, I, I64, I, D, D, D, P)
_APPLY_ARGS = (P, P, P, P, I64, I, D, P)
_MATVEC_ARGS = (P,) * 5 + (I64, I, I, I64, I, D, P)
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def check_matrix(X: torch.Tensor, what: str) -> None:
    """The operand a kernel reads: float32 or float64, 2-D and contiguous
    (the wrappers never copy it)."""
    if X.dtype not in SUFFIX:
        hint = (" (bf16 input is not supported by the CUDA kernels yet)"
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
                        what: str, *, tenants: bool = False) -> None:
    """Everything a kernel takes on trust, checked before the launch: device,
    dtype, contiguity, shapes and the index range ``0 <= flat < n_index``.
    ``tenants`` lets the vector carry a leading tenant axis, (T, vec_len)."""
    check_matrix(X, what)
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


def launch_packet(info: _build.KernelInfo, symbol: str, argtypes: tuple,
                  inputs: tuple, sizes: tuple, m: int, K: int, chunk: int,
                  scale: float, reg: float, scale_r: float | None
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Allocate the outputs and the split partials, then launch a packet
    kernel: ``symbol_{f32,f64}(*inputs, Gp, rp, G, r, *sizes, m, chunk,
    splits, scale, reg, scale_r, stream)``, or for the Gram alone
    (``scale_r`` None) ``symbol_*(*inputs, Gp, G, *sizes, m, chunk, splits,
    scale, reg, stream)`` and r None.  ``inputs[0]`` is the operand."""
    X = inputs[0]
    splits = -(-K // chunk)
    mp = -(-m // tuning.TILE) * tuning.TILE
    opts = {"dtype": X.dtype, "device": X.device}
    G = torch.empty((m, m), **opts)
    Gp = torch.empty((splits, mp, mp), **opts)
    if scale_r is None:
        r, outs, scalars = None, (Gp, G), (scale, reg)
    else:
        r = torch.empty((m,), **opts)
        rp = torch.empty((splits, mp), **opts)
        outs, scalars = (Gp, rp, G, r), (scale, reg, scale_r)
    fn = _build.bind(info.source.split("/")[-1], f"{symbol}_{SUFFIX[X.dtype]}",
                     argtypes)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in inputs + outs), *sizes, m, chunk,
                 splits, *map(float, scalars), stream)
    _build.check(err, info.name)
    info.launches += 1
    return G, r


def launch_matvec(info: _build.KernelInfo, symbol: str, argtypes: tuple,
                  X: torch.Tensor, flat: torch.Tensor, t: torch.Tensor,
                  sizes: tuple, K: int, chunk: int,
                  scale: float) -> torch.Tensor:
    """Allocate the output and the split partials, then launch a matvec
    kernel: ``symbol_{f32,f64}(X, flat, t, rp, out, *sizes, m, tenants,
    chunk, splits, scale, stream)``.  Returns (m,) for t (K,), (T, m) for
    t (T, K)."""
    m = flat.shape[0]
    tenants = 1 if t.dim() == 1 else t.shape[0]
    splits = -(-K // chunk)
    mp = -(-m // tuning.TILE) * tuning.TILE
    opts = {"dtype": X.dtype, "device": X.device}
    out = torch.empty((tenants, m), **opts)
    rp = torch.empty((splits, tenants, mp), **opts)
    fn = _build.bind(info.source.split("/")[-1], f"{symbol}_{SUFFIX[X.dtype]}",
                     argtypes)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(X.data_ptr(), flat.data_ptr(), t.data_ptr(), rp.data_ptr(),
                 out.data_ptr(), *sizes, m, tenants, chunk, splits,
                 float(scale), stream)
    _build.check(err, info.name)
    info.launches += 1
    return out if t.dim() == 2 else out[0]


def gram_packet_sampled_rows(X: torch.Tensor, flat: torch.Tensor,
                             u: torch.Tensor, *, scale: float = 1.0,
                             reg: float = 0.0, scale_r: float | None = None,
                             bk: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: the row-sampled packet for X (d, n), flat (m,) int32, u (n,)."""
    if X.device.type == "cpu":
        return ref.gram_packet_sampled_ref(X, flat, u, scale, reg, scale_r)
    d, n = X.shape
    check_cuda_operands(X, flat, u, n, d, ROWS_PACKET.name)
    chunk = resolve_chunk(flat.shape[0], n, X.dtype, "rows", bk)
    return launch_packet(ROWS_PACKET, "rows_packet", _PACKET_ARGS,
                         (X, flat, u), (n,), flat.shape[0], n, chunk, scale,
                         reg, scale if scale_r is None else scale_r)


def panel_apply_rows(X: torch.Tensor, flat: torch.Tensor, v: torch.Tensor,
                     *, scale: float = 1.0) -> torch.Tensor:
    """K2: out(n) = scale * X[flat, :]^T v for X (d, n), flat (m,), v (m,)."""
    if X.device.type == "cpu":
        return ref.panel_apply_ref(X, flat, v, scale)
    d, n = X.shape
    check_cuda_operands(X, flat, v, flat.shape[0], d, ROWS_APPLY.name)
    out = torch.empty((n,), dtype=X.dtype, device=X.device)
    fn = _build.bind("sampled_rows.cu", f"rows_apply_{SUFFIX[X.dtype]}",
                     _APPLY_ARGS)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(X.data_ptr(), flat.data_ptr(), v.data_ptr(), out.data_ptr(),
                 n, flat.shape[0], float(scale), stream)
    _build.check(err, ROWS_APPLY.name)
    ROWS_APPLY.launches += 1
    return out


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
    chunk = resolve_chunk(flat.shape[0], n, X.dtype, "rows", bk)
    return launch_matvec(ROWS_MATVEC, "rows_matvec", _MATVEC_ARGS, X, flat, t,
                         (n,), n, chunk, scale)
