"""Reference runs for the port's distributed tests: the JAX package's
sharded psum backend at ``impl="ref"`` in f64, on a host world of
``WORLD`` CPU devices, in a process of its own.

``python tests/torch_dist_ref.py <suite> <out.npz>`` runs every case of
``SUITES[suite]`` and saves its outputs in one npz (``<case>/w``,
``<case>/alpha``, ``<case>/<metric>``).  :func:`start` launches that
process in the background (the tests' port work runs meanwhile) and
:func:`load` waits for it.  The problem, the index streams and the cases
are defined here once, in numpy, for both sides; importing this module
does not import jax.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

WORLD = 4
D, N, B, LAM = 18, 41, 2, 1e-2       # n % 4 = 1 and d % 4 = 2: both pads
S, ITERS = 3, 29                     # a ragged tail: 29 % 3 = 2
BETA, T = 0.5, 3
PRIMAL_FAMILY = ("primal", "proximal", "accelerated")
FORMS = PRIMAL_FAMILY + ("dual",)
FAULTS = (("nan_packet", 2), ("bitflip", 1), ("drop_shard", 2))
FAULT_SHARD = 1


def problem():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((D, N))
    y = rng.standard_normal(N)
    return X, y


def lam1(X, y) -> float:
    """An l1 weight that zeroes some coordinates (as dist_checks')."""
    return 0.1 * float(np.max(np.abs(X @ y)) / N)


def index(form: str, iters: int = ITERS, seed: int = 2) -> np.ndarray:
    dim = N if form == "dual" else D
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(dim, B, replace=False)
                     for _ in range(iters)]).astype(np.int32)


def tenants():
    """(ys (T, N), lams) of the batched cases."""
    rng = np.random.default_rng(5)
    return rng.standard_normal((T, N)), [LAM, 10 * LAM, 0.3 * LAM]


def form_kwargs(form: str, X, y) -> dict:
    return {"proximal": {"lam1": lam1(X, y)},
            "accelerated": {"beta": BETA}}.get(form, {})


# name -> dict(kind, form, P, s, iters, extra keywords)
SUITES = {
    "distributed": (
        [dict(name=f"sh_{f}_P{P}", kind="sharded", form=f, P=P, s=S)
         for f in FORMS for P in (2, 3, 4)]
        + [dict(name=f"sh_{f}_P4_s1", kind="sharded", form=f, P=4, s=1)
           for f in ("primal", "dual")]
        + [dict(name=f"loc_{f}", kind="local", form=f, s=S) for f in FORMS]
        + [dict(name=f"guard_{f}_P4", kind="sharded", form=f, P=4, s=S,
                guard=True) for f in ("primal", "dual")]
        + [dict(name="bat_primal_P3", kind="batched", form="primal", P=3,
                s=S),
           dict(name="bat_dual_P4", kind="batched", form="dual", P=4, s=S)]),
    "recovery": (
        [dict(name=f"fault_{f}_{kind}", kind="sharded", form=f, P=4, s=S,
              iters=30, guard=True, fault=(kind, step))
         for f in ("primal", "dual", "proximal") for kind, step in FAULTS]
        + [dict(name=f"sup_{f}_{iters}", kind="supervised", form=f, s=S,
                iters=iters, fault=("device_loss", 2))
           for f, iters in (("primal", 29), ("dual", 30))]
        + [dict(name="sup_primal_nan", kind="supervised", form="primal", s=S,
                iters=30, fault=("nan_packet", 2), ckpt_every=4)]),
}


def _run_case(case: dict, X, y) -> dict:
    import jax.numpy as jnp

    import repro.core as J
    from repro.core import engine as je
    from repro.core.distributed import make_solver_mesh
    from repro.faults import FaultPlan, solve_supervised

    form, s = case["form"], case["s"]
    iters = case.get("iters", ITERS)
    idx = jnp.asarray(index(form, iters))
    kw = form_kwargs(form, X, y)
    fault = case.get("fault")
    if fault is not None:
        kind, step = fault
        fault = (FaultPlan(kind, step=step, survivors=3)
                 if kind == "device_loss"
                 else FaultPlan(kind, step=step, shard=FAULT_SHARD))
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    if case["kind"] == "local":
        solve = J.get_solver(form, "local")
        res = solve(Xj, yj, LAM, B, s, iters, None, idx=idx, impl="ref",
                    **kw)
        return {"w": res.w, "alpha": res.alpha}
    if case["kind"] == "supervised":
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            res = solve_supervised(form, "sharded", Xj, yj, LAM, B, s, iters,
                                   None, idx=idx, ckpt_dir=tmp, fault=fault,
                                   impl="ref",
                                   ckpt_every=case.get("ckpt_every", 2))
        return {"w": res.w, "alpha": res.alpha, **res.metrics}
    mesh = make_solver_mesh(case["P"])
    if case["kind"] == "batched":
        ys, lams = tenants()
        batch = je.TenantBatch(ys=jnp.asarray(ys), lams=jnp.asarray(lams))
        res = je.s_step_solve_batched_sharded(
            form, je.SolverPlan(b=B, s=s), mesh, Xj, batch, iters, None,
            idx=idx)
        return {"w": res.ws, "alpha": res.alphas}
    solve = J.get_solver(form, "sharded")
    out = solve(mesh, Xj, yj, LAM, B, s, iters, None, idx=idx, impl="ref",
                guard=case.get("guard", False), fault=fault, **kw)
    got = {"w": out[0], "alpha": out[1]}
    if case.get("guard"):
        got.update(out[2])
    return got


def main(suite: str, out: str) -> None:
    import jax
    jax.config.update("jax_enable_x64", True)
    X, y = problem()
    arrays = {}
    for case in SUITES[suite]:
        for key, value in _run_case(case, X, y).items():
            arrays[f"{case['name']}/{key}"] = np.asarray(value)
    np.savez(out, **arrays)


def start(suite: str, out: Path) -> subprocess.Popen:
    """Launch the reference runs of ``suite`` in the background."""
    here = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(here.parent / "src"), str(here), env.get("PYTHONPATH", "")])
    return subprocess.Popen([sys.executable, str(here / Path(__file__).name),
                             suite, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def load(proc: subprocess.Popen, out: Path, timeout: float) -> dict:
    """Wait for :func:`start`'s process (at most ``timeout`` seconds) and
    return its outputs, ``{case: {key: array}}``."""
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"reference runs failed:\n{log[-4000:]}")
    got = {}
    with np.load(out) as f:
        for key in f.files:
            case, name = key.split("/", 1)
            got.setdefault(case, {})[name] = f[key]
    return got


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
