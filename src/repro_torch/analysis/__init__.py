"""repro_torch.analysis -- the port's contract engine: three passes over
everything the registry can dispatch.

* ``contract_pass``: runs every registered ``(formulation, backend)``
  solver on a world of ranks and checks the contracts each formulation
  declares (``contracts()``) against each rank's record of its collective
  calls; on the card also panel-free and operand-copy-free from the
  allocator's peak (``run_memory_checks``).
* ``plan_pass``: every contraction chunk the kernels can be dispatched at
  (the live tuning table, the default picks, explicit plans) against the
  Hopper kernels' shared memory, alignment, split and index limits, and
  the packet / matvec residual order.
* ``lint``: the port's AST rules (collectives only in ``Comm``, no operand
  transpose in a formulation, no jax or reference import).

CLI: ``python -m repro_torch.analysis sweep`` (all three passes, a JSON
report) and ``python -m repro_torch.analysis lint`` (lint alone).  The
exports below load lazily, so that the lint pass and the CLI's argument
handling import no torch.
"""
from __future__ import annotations

_LAZY = {
    "Report": "report", "PassReport": "report", "Violation": "report",
    "run_contract_pass": "contract_pass",
    "run_memory_checks": "contract_pass",
    "run_plan_pass": "plan_pass", "check_chunk": "plan_pass",
    "check_plan": "plan_pass", "check_table_entry": "plan_pass",
    "run_lint": "lint", "lint_file": "lint",
    "run_sweep": "__main__",
    "expect_collectives": "api", "expect_clean": "api",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
