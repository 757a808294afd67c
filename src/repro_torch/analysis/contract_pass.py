"""Contract pass: run every registered solver, check what each formulation
declares (its ``contracts()`` hook, :class:`repro_torch.core.engine.
SolverContracts`) against each rank's record of its collective calls.

The reference lowers each solver abstractly and reads the collectives out
of the compiled HLO (``repro.analysis.hlo_pass``).  Nothing is compiled
here, so the pass runs the solves, on a small problem, on the ranks of a
:class:`~repro_torch.core.world.SolverWorld`, and reads each rank's records:
``Comm.counters()`` (the communication point's own record: calls, words,
bytes and dtypes) and a ``collectives.WireTap`` opened around the solve,
which counts the calls and words of every call into ``torch.distributed``
wherever it was made.  The count checks read the tap, so a collective made
outside ``Comm`` counts too (and is named by ``collective-outside-comm``);
once the two agree, the payload and dtype checks read ``Comm``'s record.  Over the reference's matrix -- backend,
impl, ``fuse_packet``, even and ragged iteration counts, guarded, batched
at T in {1, 8, 64}, f64 -- it checks:

* collective-count / collective-kind: the sharded backend makes exactly
  ``sync_per_outer * H`` calls, all of the declared kinds
  (``H = ceil(iters / s)``: the paper's one reduction per outer step,
  ragged tail included); the pipelined backend exactly
  ``ring_hops(P, law) * H`` hops and nothing else; guarded and batched
  solves the same budget (the health word and the tenants' directions
  ride the one reduction); a local solve none at all;
* collective-spmd: every rank made the same calls;
* gram-payload-scaled: a batched solve moves ``words(1) + (T - 1) sb H``
  words: the shared Gram is not scaled by T;
* f64-packet: an f64 solve moves only f64 words;
* operand-transpose: the shard binds X's original layout in place, no
  transposed or other copy of the local operand;
* panel-materialized / operand-copy (card only, :func:`run_memory_checks`):
  the peak bytes the allocator holds above a packet's, an apply's or a
  solve's start stay under the sampled ``(sb, contraction)`` panel's bytes
  and under the local operand's.

Sweep geometry (as the reference's): ``b, s = 4, 2``; 4 and 3 iterations
(3 % 2 leaves a ragged tail); ``d = 16 P``, ``n = 32 P``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .report import PassReport, Violation

B, S = 4, 2
ITERS_EVEN, ITERS_RAGGED = 4, 3
D_PER_P, N_PER_P = 16, 32
LAM = 1e-3
TENANTS_SWEPT = (1, 8, 64)
IMPLS = ("ref", "cuda")


def _outer_count(iters: int, s: int) -> int:
    return iters // s + (1 if iters % s else 0)


def _contracts_of(form):
    hook = getattr(form, "contracts", None)
    return None if hook is None else hook()


def _problem(d: int, n: int, dtype, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.standard_normal((d, n))).to(dtype=dtype,
                                                          device=device)
    y = torch.from_numpy(rng.standard_normal(n)).to(dtype=dtype,
                                                    device=device)
    return X, y


def _index(form, d: int, n: int, iters: int, b: int = B,
           seed: int = 1) -> torch.Tensor:
    from repro_torch.core.sampling import sample_blocks
    gen = torch.Generator().manual_seed(seed)
    return sample_blocks(gen, form.sample_dim(d, n), b, iters)


def _check_record(summary, kinds, expected: int, subject: str,
                  violations: list) -> None:
    """The kinds and the count of one rank's calls."""
    allowed = set(kinds)
    for kind, (n, _) in sorted(summary.by_kind.items()):
        if kind not in allowed:
            violations.append(Violation(
                "collective-kind", subject,
                f"disallowed {kind} x{n} (declared kinds {sorted(allowed)})"
                f": {summary}"))
    n = sum(summary.calls(k) for k in allowed)
    if n != expected:
        violations.append(Violation(
            "collective-count", subject,
            f"expected exactly {expected} {'+'.join(kinds)}, found {n}: "
            f"{summary}"))


def check_ranks(world, kinds, expected: int, subject: str,
                violations: list):
    """The world's last run (its ranks' taps open): rank 0's tapped calls
    against the budget, every rank's against rank 0's, and each rank's tap
    against its ``Comm``.  Returns rank 0's ``Comm`` summary (words, bytes
    and dtypes)."""
    from repro_torch.core.collectives import collective_summary
    tapped = [collective_summary(w) for w in world.last["wire"]]
    own = [collective_summary(c) for c in world.last["counters"]]
    _check_record(tapped[0], kinds, expected, subject, violations)
    odd = [r for r, t in enumerate(tapped) if t != tapped[0]]
    if odd:
        violations.append(Violation(
            "collective-spmd", subject,
            f"ranks {odd} made other calls than rank 0: "
            + "; ".join(f"rank {r}: {tapped[r]}" for r in [0] + odd)))
    for r, (t, c) in enumerate(zip(tapped, own)):
        if t.by_kind != c.by_kind:
            violations.append(Violation(
                "collective-outside-comm", subject,
                f"rank {r} made calls that Comm did not: wire {t}; Comm {c}"))
            break
    return own[0]


def _check_operand(form, X, y, P: int, subject: str,
                   violations: list) -> None:
    """The shard is bound in place: the operand's array IS rank 0's shard
    (same storage, shape and strides) in the declared layout."""
    d, n = X.shape
    Xl, yl = form.pad_shards(X, y, P, 0)
    op = form.bind_shard(Xl, yl, LAM, d=d, n=n).operand
    A = op.array
    if (A.data_ptr() == Xl.data_ptr() and A.shape == Xl.shape
            and A.stride() == Xl.stride()
            and op.layout == form.operand_layout):
        return
    what = ("a transposed view" if A.shape == Xl.shape[::-1]
            and A.data_ptr() == Xl.data_ptr() else
            "a transposed copy" if A.shape == Xl.shape[::-1] else "a copy")
    violations.append(Violation(
        "operand-transpose", subject,
        f"bind_shard binds {what} of the {tuple(Xl.shape)} shard "
        f"({type(op).__name__} over {tuple(A.shape)}, layout "
        f"{op.layout!r}; declared {form.operand_layout!r})"))


def _sweep_form(form, contract):
    """The formulation with its contract's sweep fields set."""
    kw = dict(contract.sweep_kwargs)
    return dataclasses.replace(form, **kw) if kw else form


def _local_cases(name, form, contract, solver, P, device, impls, rep):
    from repro_torch.core.collectives import WireTap, collective_summary
    d, n = D_PER_P * P, N_PER_P * P
    X, y = _problem(d, n, torch.float32, device)
    kw = dict(contract.sweep_kwargs)
    cases = [(impl, iters, False) for impl in impls
             for iters in (ITERS_EVEN, ITERS_RAGGED)]
    if contract.health_in_packet:
        cases += [(None, iters, True) for iters in (ITERS_EVEN, ITERS_RAGGED)]
    for impl, iters, guard in cases:
        case = rep.case(f"{name}/local[impl={impl},iters={iters}"
                        + (",guard]" if guard else "]"))
        idx = _index(form, d, n, iters)
        with WireTap() as tap:
            solver(X, y, LAM, B, S, iters, idx=idx, impl=impl, guard=guard,
                   **kw)
        if contract.local_collective_free:
            _check_record(collective_summary(tap.counters()), (), 0, case,
                          rep.violations)


def _batched_cases(name, form, contract, world, X, ys, wire, rep):
    """The batched engine (registry instance, coefficients per tenant):
    the reduction budget at every T, and the payload law."""
    from repro_torch.core import engine
    P = world.size
    d, n = X.shape
    sb = S * B
    kinds = (contract.collective_kinds if wire == "psum"
             else contract.pipelined_collective_kinds)
    per_sync = (contract.sync_per_outer if wire == "psum"
                else engine.ring_hops([P], contract.pipelined_hops))
    tenants = TENANTS_SWEPT if wire == "psum" else (8,)
    words = {}
    for T in tenants:
        for iters in ((ITERS_EVEN, ITERS_RAGGED) if T == 8
                      else (ITERS_EVEN,)):
            tag = "batched" if wire == "psum" else "pipelined-batched"
            case = rep.case(f"{name}/{tag}[T={T},iters={iters}]")
            coeffs = {k: [v] * T for k, v in contract.sweep_kwargs}
            batch = engine.TenantBatch(ys=ys[:T].contiguous(),
                                       lams=[LAM] * T, coeffs=coeffs)
            plan = engine.SolverPlan(b=B, s=S, wire=wire)
            world.solve_batched(form, plan, X, batch, iters,
                                idx=_index(form, d, n, iters))
            H = _outer_count(iters, S)
            summ = check_ranks(world, kinds, per_sync * H, case,
                                rep.violations)
            if iters == ITERS_EVEN:
                words[T] = summ.words
    if wire != "psum":
        return
    H = _outer_count(ITERS_EVEN, S)
    for T in TENANTS_SWEPT[1:]:
        want = words[1] + (T - 1) * sb * H
        if words[T] != want:
            rep.violations.append(Violation(
                "gram-payload-scaled", f"{name}/batched[T={T}]",
                f"wire payload {words[T]} words != {want} (= T=1 payload "
                f"{words[1]} + (T-1)*sb*H): the shared sb x sb Gram must "
                "not scale with the tenant axis"))


def _distributed_cases(name, form, contract, backends, world, impls, rep):
    from repro_torch.core import engine
    P = world.size
    d, n = D_PER_P * P, N_PER_P * P
    X, y = _problem(d, n, torch.float32, world.device)
    kw = dict(contract.sweep_kwargs)
    ranks = world.ranks(P)
    if contract.operand_transpose_free:
        case = rep.case(f"{name}/bind_shard[P={P}]")
        _check_operand(_sweep_form(form, contract), X, y, P, case,
                       rep.violations)

    def run(backend, case, kinds, expected, iters, operands=(X, y), **skw):
        engine.get_solver(name, backend)(
            ranks, *operands, LAM, B, S, iters,
            idx=_index(form, d, n, iters), **kw, **skw)
        return check_ranks(world, kinds, expected, case, rep.violations)

    if "sharded" in backends:
        kinds, per = contract.collective_kinds, contract.sync_per_outer
        for impl in impls:
            for fuse in (True, False):
                for iters in (ITERS_EVEN, ITERS_RAGGED):
                    case = rep.case(f"{name}/sharded[impl={impl},fuse={fuse},"
                                    f"iters={iters}]")
                    run("sharded", case, kinds, per * _outer_count(iters, S),
                        iters, impl=impl, fuse_packet=fuse)
        if contract.health_in_packet:
            for fuse in (True, False):
                for iters in (ITERS_EVEN, ITERS_RAGGED):
                    case = rep.case(f"{name}/sharded[fuse={fuse},"
                                    f"iters={iters},guard]")
                    run("sharded", case, kinds, per * _outer_count(iters, S),
                        iters, fuse_packet=fuse, guard=True)
        if contract.tenant_batched:
            ys = torch.stack([y * (1 + t / 64) for t in range(64)])
            _batched_cases(name, form, contract, world, X, ys, "psum", rep)
        if contract.f64_packet:
            case = rep.case(f"{name}/sharded[f64]")
            summ = run("sharded", case, kinds,
                       per * _outer_count(ITERS_EVEN, S), ITERS_EVEN,
                       operands=(X.double(), y.double()))
            if set(summ.dtypes) != {"float64"}:
                rep.violations.append(Violation(
                    "f64-packet", case,
                    f"an f64 solve moved {sorted(summ.dtypes)}, expected "
                    "every call to carry float64"))
    if "pipelined" in backends:
        kinds = contract.pipelined_collective_kinds
        hops = engine.ring_hops([P], contract.pipelined_hops)
        for impl in impls:
            for iters in (ITERS_EVEN, ITERS_RAGGED):
                case = rep.case(f"{name}/pipelined[impl={impl},"
                                f"iters={iters}]")
                run("pipelined", case, kinds, hops * _outer_count(iters, S),
                    iters, impl=impl)
        if contract.health_in_packet:
            for iters in (ITERS_EVEN, ITERS_RAGGED):
                case = rep.case(f"{name}/pipelined[iters={iters},guard]")
                run("pipelined", case, kinds, hops * _outer_count(iters, S),
                    iters, guard=True)
        if contract.tenant_batched:
            ys = torch.stack([y * (1 + t / 8) for t in range(8)])
            _batched_cases(name, form, contract, world, X, ys, "ring", rep)


def run_contract_pass(world, formulations=None) -> PassReport:
    """Sweep the solver registry (or the named ``formulations``) on
    ``world``'s ranks, all of them; local solves run in this process on
    the world's device.  The cases of ``impl="cuda"`` run on a CUDA world
    only."""
    import repro_torch.core  # noqa: F401  (registers the built-in solvers)
    from repro_torch.core.engine import FORMULATIONS, registered_solvers

    rep = PassReport("contracts")
    device = world.device
    impls = IMPLS if device.type == "cuda" else ("ref",)
    backends: dict = {}
    for name, backend in registered_solvers():
        backends.setdefault(name, set()).add(backend)
    names = sorted(formulations) if formulations else sorted(backends)
    tap, world.tap_wire = world.tap_wire, True
    try:
        for name in names:
            form = FORMULATIONS[name]
            contract = _contracts_of(form)
            if contract is None:
                rep.violations.append(Violation(
                    "contracts-missing", rep.case(name),
                    f"formulation {name!r} declares no contracts() hook"))
                continue
            if "cuda" not in impls:
                rep.skip(f"{name}/*[impl=cuda]",
                         "impl='cuda' runs the kernels: CUDA tensors only")
            registered = backends.get(name, set())
            if "local" in registered:
                _local_cases(name, form, contract,
                             repro_torch.core.get_solver(name, "local"),
                             world.size, device, impls, rep)
            if registered & {"sharded", "pipelined"}:
                _distributed_cases(name, form, contract, registered, world,
                                   impls, rep)
            rep.skip(f"{name}/memory",
                     "panel-free and operand-copy-free are read from the "
                     "CUDA allocator's peak: on the card only"
                     if device.type != "cuda" else
                     "at the sweep's geometry the panel is smaller than the "
                     "solve's vectors: run_memory_checks takes a real-size "
                     "operand (chip_smoke.py phase 10)")
    finally:
        world.tap_wire = tap
    return rep


def _peak(fn) -> int:
    """Peak bytes the CUDA allocator held above its level at the start of
    ``fn()`` (the output kept alive until measured)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def _check_peak(rep: PassReport, what: str, peak: int, panel: int,
                operand: int) -> None:
    """One measured case, named with its peak and both limits."""
    subject = rep.case(f"{what}: peak {peak} B (panel {panel} B, operand "
                       f"{operand} B)")
    violations = rep.violations
    if peak >= panel:
        violations.append(Violation(
            "panel-materialized", subject,
            f"{peak} bytes allocated above the start, not under the "
            f"{panel}-byte sampled panel"))
    if peak >= operand:
        violations.append(Violation(
            "operand-copy", subject,
            f"{peak} bytes allocated above the start, not under the "
            f"{operand}-byte local operand"))


def run_memory_checks(world, X, y, lam: float, rep: PassReport, *,
                      b: int = 8, s: int = 16, formulations=None) -> None:
    """Panel-free and operand-copy-free through the kernels, on the card, at
    the operand ``X`` (sized so that the panel dwarfs the solve's vectors):
    for every formulation whose contract lists ``"cuda"`` in
    ``panel_free_impls``, the packet and the apply on X, a local solve of
    two outer steps, and a sharded solve on ``world``'s ranks (each rank's
    peak against its shard's panel and bytes).  Appends to ``rep``."""
    import repro_torch.core  # noqa: F401
    from repro_torch.core import engine
    from repro_torch.kernels.gram import (gram_packet_sampled, panel_apply,
                                          panel_matvec)

    if X.device.type != "cuda":
        raise ValueError("run_memory_checks reads the CUDA allocator: pass "
                         "X on the card")
    d, n = X.shape
    P = world.size
    isz = X.element_size()
    sb = s * b
    iters = 2 * s
    names = sorted(formulations) if formulations else sorted(
        {f for f, _ in engine.registered_solvers()})
    for name in names:
        form = engine.FORMULATIONS[name]
        contract = _contracts_of(form)
        if contract is None or "cuda" not in contract.panel_free_impls:
            continue
        kw = dict(contract.sweep_kwargs)
        sform = _sweep_form(form, contract)
        bound = sform.bind(X, y, lam)
        op = bound.operand
        K = op.contraction
        panel, operand = sb * K * isz, X.numel() * isz
        idx = _index(form, d, n, iters, b=b)
        flat = idx[:s].reshape(-1).to(X.device, torch.int32)
        u = torch.ones((K,), dtype=X.dtype, device=X.device)
        v = torch.ones((b,), dtype=X.dtype, device=X.device)
        tag = f"{name}/memory[impl=cuda,sb={sb}]"
        for what, m, fn in (
                ("packet", sb, lambda: gram_packet_sampled(op, flat, u,
                                                           impl="cuda")),
                ("matvec", sb, lambda: panel_matvec(op, flat, u,
                                                    impl="cuda")),
                ("apply", b, lambda: panel_apply(op, flat[:b], v,
                                                 impl="cuda"))):
            _check_peak(rep, f"{tag} {what}", _peak(fn), m * K * isz,
                        operand)
        del bound, op
        local = engine.get_solver(name, "local")
        _check_peak(rep, f"{tag} local solve, {iters} iterations",
                    _peak(lambda: local(X, y, lam, b, s, iters, idx=idx,
                                        impl="cuda", **kw)),
                    panel, operand)
        backends = {bk for f, bk in engine.registered_solvers() if f == name}
        if "sharded" not in backends:
            continue
        Xl, _ = form.pad_shards(X, None, P, P - 1)
        shard_panel = sb * (Xl.shape[1] if form.operand_layout == "rows"
                            else Xl.shape[0]) * isz
        shard_bytes = Xl.numel() * isz
        del Xl
        world.track_peak = True
        try:
            engine.get_solver(name, "sharded")(world, X, y, lam, b, s, iters,
                                               idx=idx, impl="cuda", **kw)
        finally:
            world.track_peak = False
        for r, pk in enumerate(world.last["peak_bytes"]):
            _check_peak(rep, f"{tag} sharded solve on {P} ranks, rank {r}",
                        pk, shard_panel, shard_bytes)
