"""repro_torch.core -- CA-BCD / CA-BDCD for regularized least squares on one
device, in PyTorch: the s-step engine, its two ridge formulations, sampling,
the block subproblem solves and the direct ground truth."""
from .engine import (FORMULATIONS, DualRidge, PrimalRidge, SolveResult,
                     SolverPlan, get_solver, register_solver,
                     registered_solvers, s_step_solve)
from .bcd import bcd, ca_bcd, objective
from .bdcd import bdcd, ca_bdcd
from .direct import ridge_exact
from .sampling import overlap_matrix, sample_blocks
from .subproblem import block_forward_substitution, solve_spd

__all__ = [
    "FORMULATIONS", "DualRidge", "PrimalRidge", "SolveResult", "SolverPlan",
    "get_solver", "register_solver", "registered_solvers", "s_step_solve",
    "bcd", "ca_bcd", "objective", "bdcd", "ca_bdcd", "ridge_exact",
    "overlap_matrix", "sample_blocks", "block_forward_substitution",
    "solve_spd",
]
