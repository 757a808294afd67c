"""Deliberately broken formulations and tuning tables for the port's
contract engine (``repro_torch.analysis``), the counterparts of the
reference's ``_analysis_checks.py`` mutants.  Each must make the sweep fail
with a violation naming its case.

The formulations live at module level so that the world's spawned ranks
unpickle them by import; :func:`registered` puts one in the registry (its
formulation and its sharded or pipelined entry) and takes it out again.
The extra collectives are raw ``torch.distributed`` calls: no formulation
hook sees the rank's ``Comm``, and the contract pass's tap counts every
call.

Run as a script, it registers the named mutant and runs the CLI's sweep on
the CPU: ``PYTHONPATH=src:tests python tests/_torch_analysis_mutants.py
second_all_reduce`` exits nonzero.
"""
import contextlib
import dataclasses
import sys

import torch
import torch.distributed as dist

from repro_torch.core import engine
from repro_torch.core.engine import (DualRidge, PrimalRidge, RowMajorOperand,
                                     SolverContracts, _BoundPrimal)
from repro_torch.kernels.gram import tuning


def _all_reduce_mean(dx):
    out = dx.clone()
    dist.all_reduce(out)  # contract: allow-collective (the mutation)
    return out / dist.get_world_size()


def _extra_hop(dx):
    P, me = dist.get_world_size(), dist.get_rank()
    send = dx.detach().cpu().contiguous()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([  # contract: allow-collective
            dist.P2POp(dist.isend, send, (me + 1) % P),
            dist.P2POp(dist.irecv, recv, (me - 1) % P)]):
        req.wait()
    return dx


@dataclasses.dataclass(frozen=True)
class _SecondAllReduceBound(_BoundPrimal):
    def update(self, carry, idx, dx, pp, block=None):
        # The mutation: a second all-reduce per update (its result used).
        return super().update(carry, idx, _all_reduce_mean(dx), pp, block)


@dataclasses.dataclass(frozen=True)
class _ExtraHopBound(_BoundPrimal):
    def update(self, carry, idx, dx, pp, block=None):
        # The mutation: one more ring hop per update.
        return super().update(carry, idx, _extra_hop(dx), pp, block)


def _rebind(bound, cls):
    return cls(**{f.name: getattr(bound, f.name)
                  for f in dataclasses.fields(bound)})


class SecondAllReducePrimal(PrimalRidge):
    """A second all-reduce riding the update."""
    name = "evil-second-all-reduce"

    def bind_shard(self, Xl, yl, lam, *, d, n, x0=None):
        return _rebind(super().bind_shard(Xl, yl, lam, d=d, n=n, x0=x0),
                       _SecondAllReduceBound)


class GuardReducePrimal(PrimalRidge):
    """Claims the health word rides the packet, but adds a reduction: the
    guarded cases must fail too."""
    name = "evil-guard-reduce"

    def contracts(self):
        return SolverContracts(health_in_packet=True)

    def bind_shard(self, Xl, yl, lam, *, d, n, x0=None):
        return _rebind(super().bind_shard(Xl, yl, lam, d=d, n=n, x0=x0),
                       _SecondAllReduceBound)


class ExtraHopPrimal(PrimalRidge):
    """One hop more than the ring's 2 (P - 1) per reduction."""
    name = "evil-extra-hop"

    def contracts(self):
        return SolverContracts()

    def bind_shard(self, Xl, yl, lam, *, d, n, x0=None):
        return _rebind(super().bind_shard(Xl, yl, lam, d=d, n=n, x0=x0),
                       _ExtraHopBound)


class PreTransposeDual(DualRidge):
    """The pre-transposed dual operand: a row-major copy of the shard's
    transpose."""
    name = "evil-pretranspose"

    def bind_shard(self, Xl, yl, lam, *, d, n, x0=None):
        bound = super().bind_shard(Xl, yl, lam, d=d, n=n, x0=x0)
        return dataclasses.replace(
            bound, operand=RowMajorOperand(Xl.T.contiguous()))


class NoContractsPrimal(PrimalRidge):
    """No contracts() hook at all."""
    name = "evil-no-contracts"
    contracts = None


FORMULATION_MUTANTS = {
    "second_all_reduce": (SecondAllReducePrimal, "sharded"),
    "guard_reduce": (GuardReducePrimal, "sharded"),
    "extra_hop": (ExtraHopPrimal, "pipelined"),
    "pretranspose": (PreTransposeDual, "sharded"),
    "no_contracts": (NoContractsPrimal, "sharded"),
}


def _solver(form, wire):
    def solve(world, X, y, lam, b, s, iters, generator=None, *,
              fuse_packet=True, idx=None, impl=None, tiles=None, guard=False,
              fault=None, x0=None, step0=0):
        plan = engine.SolverPlan(b=b, s=s, impl=impl, tiles=tiles,
                                 fuse_packet=fuse_packet, guard=guard,
                                 fault=fault, wire=wire)
        return world.solve(form, plan, X, y, lam, iters, generator, idx=idx,
                           x0=x0, step0=step0)
    return solve


@contextlib.contextmanager
def registered(mutant: str):
    """Register the formulation mutant ``mutant`` and its backend entry;
    yields its name."""
    cls, backend = FORMULATION_MUTANTS[mutant]
    form = engine.register_formulation(cls())
    engine.register_solver(form.name, backend,
                           _solver(form, "ring" if backend == "pipelined"
                                   else "psum"))
    try:
        yield form.name
    finally:
        engine.FORMULATIONS.pop(form.name, None)
        engine._REGISTRY.pop((form.name, backend), None)


# Table mutants: entries the plan pass must refuse.  The oversized one's
# chunk outgrows its own K bucket.  In the shipped format one entry serves
# a key's packet and its matvec alike, so no entry can split them; the
# residual-order mutant is the table a per-kernel sweep could write, with a
# matvec chunk of its own, installed where the matvecs look their chunk up.
OVERSIZED_ENTRY = {"128,32768,float32,rows": 65536}
RESIDUAL_ORDER_ENTRY = {"128,32768,float32,rows": 512}
MATVEC_ONLY_CHUNK = 1024


@contextlib.contextmanager
def table(mutant: str):
    """Install the table mutant ``mutant`` (``oversized_entry`` or
    ``residual_order``); restores the live table on exit."""
    from repro_torch.kernels.gram import sampled_kernel
    saved = dict(tuning._TABLE)
    resolve = sampled_kernel.resolve_chunk
    try:
        if mutant == "oversized_entry":
            tuning.register_table(OVERSIZED_ENTRY)
        elif mutant == "residual_order":
            tuning.register_table(RESIDUAL_ORDER_ENTRY)
            (key, _), = RESIDUAL_ORDER_ENTRY.items()
            mb, kb, dt, layout = key.split(",")

            def matvec_chunk(m, K, dtype, lay, bk):
                hit = (bk is None and lay == layout
                       and tuning._bucket(m) == int(mb)
                       and tuning._bucket(K) == int(kb))
                return MATVEC_ONLY_CHUNK if hit else resolve(m, K, dtype,
                                                             lay, bk)
            # matvec_geometry resolves its chunk here; dense_geometry holds
            # its own reference to the original.
            sampled_kernel.resolve_chunk = matvec_chunk
        else:
            raise KeyError(mutant)
        yield
    finally:
        sampled_kernel.resolve_chunk = resolve
        tuning._TABLE.clear()
        tuning._TABLE.update(saved)


def main(argv) -> int:
    from repro_torch.analysis.__main__ import main as sweep_main
    mutant = argv[0]
    args = ["sweep", "--device", "cpu", *argv[1:]]
    if mutant in FORMULATION_MUTANTS:
        with registered(mutant) as name:
            return sweep_main(args + ["--formulation", name])
    with table(mutant):
        return sweep_main(args)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
