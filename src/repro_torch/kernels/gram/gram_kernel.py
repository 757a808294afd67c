"""Wrappers of the dense Gram CUDA kernels K7 and K8 (``csrc/gram_dense.cu``),
on an operand A (m, K) that is already materialised.

* :func:`gram_packet_dense` (K7) -- ``(G, r) = (scale * A A^T + reg * I,
  scale_r * A u)``.  Replaces ``gram_packet_pallas`` (``src/repro/kernels/
  gram/gram_kernel.py``).  K1's kernel reading A's own rows: it takes K1's
  chunk for the same (m, K), so ``K7(X[flat], u)`` equals
  ``K1(X, flat, u)`` bit for bit.  Bounded by its m(m+1)/2 * K
  multiply-adds on the f32 CUDA cores.
* :func:`gram_dense` (K8) -- ``G = scale * A A^T + reg * I``.  Replaces
  ``gram_pallas`` (same file): K7 with the residual statically absent, so
  its G equals K7's G bit for bit.  The R-factor Gram of CholeskyQR
  (``core.tsqr.cholqr_r``).

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches the
kernel or raises.  A must be contiguous: the wrappers never copy it.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .sampled_kernel import (D, I, I64, P, check_matrix, check_vector,
                             launch_packet, resolve_chunk)

DENSE_PACKET = _build.KernelInfo(
    "gram_packet_dense", "src/repro_torch/csrc/gram_dense.cu",
    "src/repro/kernels/gram/gram_kernel.py:112")
DENSE_GRAM = _build.KernelInfo(
    "gram_dense", "src/repro_torch/csrc/gram_dense.cu",
    "src/repro/kernels/gram/gram_kernel.py:161")

# dense_packet_*(A, u, Gp, rp, G, r, K, m, chunk, splits, scale, reg, scale_r,
#                stream); dense_gram_*(A, Gp, G, K, m, chunk, splits, scale,
#                reg, stream)
_PACKET_ARGS = (P,) * 6 + (I64, I, I64, I, D, D, D, P)
_GRAM_ARGS = (P,) * 3 + (I64, I, I64, I, D, D, P)


def _check_operand(A: torch.Tensor, what: str) -> tuple[int, int]:
    check_matrix(A, what)
    if A.numel() == 0:
        raise ValueError(f"{what}: A must be non-empty, got shape "
                         f"{tuple(A.shape)}")
    return A.shape


def gram_packet_dense(A: torch.Tensor, u: torch.Tensor, *,
                      scale: float = 1.0, reg: float = 0.0,
                      scale_r: float | None = None, bk: int | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: the packet on a materialised A (m, K) and u (K,)."""
    if A.device.type == "cpu":
        return ref.gram_packet_ref(A, u, scale, reg, scale_r)
    m, K = _check_operand(A, DENSE_PACKET.name)
    check_vector(A, u, K, DENSE_PACKET.name, name="u")
    chunk = resolve_chunk(m, K, A.dtype, "rows", bk)
    return launch_packet(DENSE_PACKET, "dense_packet", _PACKET_ARGS, (A, u),
                         (K,), m, K, chunk, scale, reg,
                         scale if scale_r is None else scale_r)


def gram_dense(A: torch.Tensor, *, scale: float = 1.0, reg: float = 0.0,
               bk: int | None = None) -> torch.Tensor:
    """K8: G = scale * A A^T + reg * I for a materialised A (m, K)."""
    if A.device.type == "cpu":
        return ref.gram_ref(A, scale, reg)
    m, K = _check_operand(A, DENSE_GRAM.name)
    chunk = resolve_chunk(m, K, A.dtype, "rows", bk)
    G, _ = launch_packet(DENSE_GRAM, "dense_gram", _GRAM_ARGS, (A,), (K,), m,
                         K, chunk, scale, reg, None)
    return G
