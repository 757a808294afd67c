"""repro_torch.core -- CA-BCD / CA-BDCD / CA proximal and accelerated BCD
for regularized least squares in PyTorch, on one device or sharded over
the ranks of a ``torch.distributed`` world: the s-step engine with its
health guards and its tenant-batched driver, its sharded and pipelined
backends (:class:`SolverWorld`), the ridge, elastic-net and momentum
formulations, sampling, the block subproblem solves, the direct ground
truth and the baselines the paper compares against (CG, TSQR and
CholeskyQR)."""
from repro_torch.kernels.gram import (PacketPlan, gram, gram_packet,
                                      gram_packet_sampled, normal_matvec,
                                      panel_apply, panel_matvec)
from .engine import (FORMULATIONS, BatchedSolveResult, Comm, DualRidge,
                     PrimalRidge, SolveResult, SolverContracts, SolverPlan,
                     TenantBatch,
                     all_reduce_variadic, batched_residuals, get_solver,
                     register_formulation, register_solver,
                     registered_solvers, ring_hops, ring_reduce_variadic,
                     s_step_solve, s_step_solve_batched,
                     s_step_solve_batched_sharded, s_step_solve_sharded)
from .bcd import bcd, ca_bcd, objective
from .bdcd import bdcd, ca_bdcd
from .direct import ridge_exact
from .krylov import CGResult, cg_ridge, cg_ridge_history
from .distributed import (bcd_sharded, bdcd_sharded, ca_bcd_pipelined,
                          ca_bcd_sharded, ca_bdcd_pipelined, ca_bdcd_sharded)
from .proximal import (ProximalElasticNet, ca_proximal_bcd,
                       ca_proximal_bcd_pipelined, ca_proximal_bcd_sharded,
                       elastic_net_objective, proximal_bcd,
                       proximal_bcd_reference)
from .accelerated import (MomentumWrapper, accelerated_bcd,
                          ca_accelerated_bcd, ca_accelerated_bcd_pipelined,
                          ca_accelerated_bcd_sharded)
from .sampling import overlap_matrix, sample_blocks, sample_blocks_balanced
from .world import SolverWorld, plan_solver_world
from .subproblem import (block_forward_substitution,
                         block_forward_substitution_prox, soft_threshold,
                         solve_spd)
from .tsqr import cholqr_r, tsqr, tsqr_ridge
from .collectives import CollectiveSummary, collective_summary
from . import cost_model

__all__ = [
    "FORMULATIONS", "DualRidge", "PrimalRidge", "SolveResult", "SolverPlan",
    "TenantBatch", "BatchedSolveResult", "s_step_solve_batched",
    "batched_residuals", "get_solver", "register_formulation",
    "register_solver", "registered_solvers", "s_step_solve",
    "bcd", "ca_bcd", "objective", "bdcd", "ca_bdcd", "ridge_exact",
    "ProximalElasticNet", "ca_proximal_bcd", "proximal_bcd",
    "proximal_bcd_reference", "elastic_net_objective",
    "MomentumWrapper", "accelerated_bcd", "ca_accelerated_bcd",
    "Comm", "SolverWorld", "plan_solver_world", "all_reduce_variadic",
    "ring_hops", "ring_reduce_variadic", "s_step_solve_sharded",
    "s_step_solve_batched_sharded", "ca_bcd_sharded", "bcd_sharded",
    "ca_bdcd_sharded", "bdcd_sharded", "ca_bcd_pipelined",
    "ca_bdcd_pipelined", "ca_proximal_bcd_sharded",
    "ca_proximal_bcd_pipelined", "ca_accelerated_bcd_sharded",
    "ca_accelerated_bcd_pipelined", "sample_blocks_balanced",
    "overlap_matrix", "sample_blocks", "block_forward_substitution",
    "block_forward_substitution_prox", "soft_threshold", "solve_spd",
    "CGResult", "cg_ridge", "cg_ridge_history", "tsqr", "cholqr_r",
    "tsqr_ridge", "gram", "gram_packet", "normal_matvec",
    "SolverContracts", "PacketPlan", "gram_packet_sampled",
    "panel_apply", "panel_matvec", "CollectiveSummary", "collective_summary",
    "cost_model",
]
