"""Gram-packet kernels for the s-step solvers and the baselines: plain
PyTorch versions (``ref``) and hand-written CUDA kernels for Hopper
(``csrc/``).

``KERNELS`` lists the CUDA kernels with their launch counters, one per TPU
kernel; ``BF16_KERNELS`` the bf16 builds of the packets K1, K3 and K7, counted
apart; ``launch_counts`` reads every counter of both."""
from . import tuning
from .gram_kernel import (DENSE_GRAM, DENSE_PACKET, DENSE_PACKET_BF16,
                          gram_dense, gram_packet_dense)
from .operands import (ColMajorOperand, MaterializedOperand, PacketOperand,
                       RowMajorOperand, as_operand)
from .ops import (PacketPlan, gram, gram_packet, gram_packet_sampled,
                  normal_matvec, panel_apply, panel_matvec)
from .ref import (gram_packet_ref, gram_packet_sampled_cols_ref,
                  gram_packet_sampled_ref, gram_ref, panel_apply_cols_ref,
                  panel_apply_ref, panel_matvec_cols_ref, panel_matvec_ref)
from .sampled_colmajor import (COLS_APPLY, COLS_MATVEC, COLS_PACKET,
                               COLS_PACKET_BF16, gram_packet_sampled_cols, panel_apply_cols,
                               panel_matvec_cols)
from .sampled_kernel import (ROWS_APPLY, ROWS_MATVEC, ROWS_PACKET,
                             ROWS_PACKET_BF16, gram_packet_sampled_rows,
                             panel_apply_rows, panel_matvec_rows)

KERNELS = (ROWS_PACKET, ROWS_APPLY, COLS_PACKET, COLS_APPLY, COLS_MATVEC,
           ROWS_MATVEC, DENSE_PACKET, DENSE_GRAM)
BF16_KERNELS = (ROWS_PACKET_BF16, DENSE_PACKET_BF16, COLS_PACKET_BF16)


def launch_counts() -> dict:
    """Every kernel's launches, f32 / f64 and bf16 builds, by name."""
    return {k.name: k.launches for k in KERNELS + BF16_KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS + BF16_KERNELS:
        k.launches = 0


__all__ = [
    "PacketPlan", "PacketOperand", "RowMajorOperand", "ColMajorOperand",
    "MaterializedOperand", "as_operand", "gram", "gram_packet",
    "gram_packet_sampled", "panel_apply", "panel_matvec", "normal_matvec",
    "gram_ref", "gram_packet_ref", "gram_packet_sampled_ref",
    "gram_packet_sampled_cols_ref", "panel_apply_ref", "panel_apply_cols_ref",
    "panel_matvec_ref", "panel_matvec_cols_ref",
    "gram_packet_sampled_rows", "panel_apply_rows", "panel_matvec_rows",
    "gram_packet_sampled_cols", "panel_apply_cols", "panel_matvec_cols",
    "gram_packet_dense", "gram_dense", "KERNELS", "BF16_KERNELS",
    "launch_counts", "reset_launch_counts", "tuning",
]
