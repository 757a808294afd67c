"""The PacketOperand layer: the operand array, its layout and its gather.

Semantics over the implicit sampled panel ``Y(flat)``, shape (m, C):

    packet(flat, u):  G = scale * Y Y^T + reg * I,   r = scale_r * Y u
    apply(flat, v):   out(C) = scale * Y^T v
    matvec(flat, t):  out(m) = scale * Y t   (t (C,), or (T, C) -> (T, m))

* :class:`RowMajorOperand` -- array (S, C), samples are rows (the primal's
  X); kernels K1/K2/K6 of ``sampled_kernel.py``.
* :class:`ColMajorOperand` -- array (C, S), samples are columns of the
  original layout (the dual's X, never transposed); kernels K3/K4/K5 of
  ``sampled_colmajor.py``.
* :class:`MaterializedOperand` -- array K (S, S) of products formed
  beforehand (a kernel matrix): the packet gathers ``K[flat][:, flat]``
  instead of contracting, with the same torch code on every backend.

``matvec`` sums in the packet's residual order, so at the same ``bk`` it
equals the packet's r bit for bit on either backend.

The operands never pad the array: the kernels mask their ragged edges, so no
call copies the dataset.  Knob resolution (``impl``/``bk``) stays in
``ops.py``; ``impl`` arrives here as ``"ref"`` or ``"cuda"``.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from . import ref
from .sampled_colmajor import (gram_packet_sampled_cols, panel_apply_cols,
                               panel_matvec_cols)
from .sampled_kernel import (gram_packet_sampled_rows, panel_apply_rows,
                             panel_matvec_rows)


def _int32(flat: torch.Tensor) -> torch.Tensor:
    return flat.to(torch.int32).contiguous()


@dataclasses.dataclass(frozen=True)
class RowMajorOperand:
    """Array (S, C); samples rows: ``Y = array[flat, :]``."""
    array: torch.Tensor
    layout: ClassVar[str] = "rows"

    @property
    def dtype(self):
        return self.array.dtype

    @property
    def samples(self) -> int:
        return self.array.shape[0]

    @property
    def contraction(self) -> int:
        return self.array.shape[1]

    def packet(self, flat, u, *, scale, reg, scale_r, impl, bk):
        if impl == "ref":
            return ref.gram_packet_sampled_ref(self.array, flat, u, scale,
                                               reg, scale_r)
        return gram_packet_sampled_rows(self.array, _int32(flat), u,
                                        scale=scale, reg=reg,
                                        scale_r=scale_r, bk=bk)

    def apply(self, flat, v, *, scale, impl):
        if impl == "ref":
            return ref.panel_apply_ref(self.array, flat, v, scale)
        return panel_apply_rows(self.array, _int32(flat), v, scale=scale)

    def matvec(self, flat, t, *, scale, impl, bk):
        if impl == "ref":
            return ref.panel_matvec_ref(self.array, flat, t, scale)
        return panel_matvec_rows(self.array, _int32(flat), t, scale=scale,
                                 bk=bk)


@dataclasses.dataclass(frozen=True)
class ColMajorOperand:
    """Array (C, S); samples columns of the original layout:
    ``Y = array[:, flat].T``."""
    array: torch.Tensor
    layout: ClassVar[str] = "cols"

    @property
    def dtype(self):
        return self.array.dtype

    @property
    def samples(self) -> int:
        return self.array.shape[1]

    @property
    def contraction(self) -> int:
        return self.array.shape[0]

    def packet(self, flat, u, *, scale, reg, scale_r, impl, bk):
        if impl == "ref":
            return ref.gram_packet_sampled_cols_ref(self.array, flat, u,
                                                    scale, reg, scale_r)
        return gram_packet_sampled_cols(self.array, _int32(flat), u,
                                        scale=scale, reg=reg,
                                        scale_r=scale_r, bk=bk)

    def apply(self, flat, v, *, scale, impl):
        if impl == "ref":
            return ref.panel_apply_cols_ref(self.array, flat, v, scale)
        return panel_apply_cols(self.array, _int32(flat), v, scale=scale)

    def matvec(self, flat, t, *, scale, impl, bk):
        if impl == "ref":
            return ref.panel_matvec_cols_ref(self.array, flat, t, scale)
        return panel_matvec_cols(self.array, _int32(flat), t, scale=scale,
                                 bk=bk)


@dataclasses.dataclass(frozen=True)
class MaterializedOperand:
    """Array K (S, S) of pre-materialised products: the packet's Gram is
    gathered, not contracted -- ``G = scale * K[flat][:, flat] + reg * I``,
    ``r = scale_r * K[flat, :] u``.  There is no panel to fuse away, so every
    backend runs the same torch gather (no kernel is owed for it)."""
    array: torch.Tensor
    layout: ClassVar[str] = "materialized"

    @property
    def dtype(self):
        return self.array.dtype

    @property
    def samples(self) -> int:
        return self.array.shape[0]

    @property
    def contraction(self) -> int:
        return self.array.shape[1]

    def packet(self, flat, u, *, scale, reg, scale_r, impl, bk):
        acc = ref.acc_dtype(self.dtype)
        fl = flat.long()
        rows = self.array[fl, :].to(acc)
        G = scale * rows[:, fl] + reg * torch.eye(fl.shape[0], dtype=acc,
                                                  device=rows.device)
        sr = scale if scale_r is None else scale_r
        return G, sr * (rows @ u.to(acc))

    def apply(self, flat, v, *, scale, impl):
        return ref.panel_apply_ref(self.array, flat, v, scale)

    def matvec(self, flat, t, *, scale, impl, bk):
        return ref.panel_matvec_ref(self.array, flat, t, scale)


PacketOperand = RowMajorOperand | ColMajorOperand | MaterializedOperand


def as_operand(x) -> PacketOperand:
    """Operands pass through; a raw tensor means row-major."""
    if isinstance(x, (RowMajorOperand, ColMajorOperand,
                      MaterializedOperand)):
        return x
    return RowMajorOperand(x)
