"""A persistent process world for the distributed backends.

:class:`SolverWorld` spawns its ranks once (``torch.multiprocessing``, spawn
start method) and serves many solves through a command queue per rank; a
respawn per solve would cost seconds each.

* The ranks join one ``torch.distributed`` group through a ``file://``
  rendezvous in a private temporary directory, and make a group of the
  first P ranks for every P, so a call with ``n_ranks=P`` runs on P of
  them (P = 1 is a group of one, with no hops).
* Each X is handed to the ranks once (shared memory on the CPU, CUDA IPC on
  the card: no copy in the parent), and each rank cuts its own contiguous,
  zero-padded shard from it (the formulation's ``pad_shards``).  The ranks
  hold one shard per layout (X's sharded axis): a solve on another X, on
  another rank count or on an X changed in place drops the layout's shard
  and cuts anew, so a long-lived world holds one sharded copy per layout
  in use, and the world a reference to its X.
* A solve ships the plan, the small vectors and the shared ``idx``; every
  rank runs the SPMD function (``engine.s_step_solve_sharded`` or
  ``s_step_solve_batched_sharded``) on its shard; the world gathers the
  halves, checks that the replicated iterate is the same bytes on every
  rank (a rank whose replica differs is a fault: it raises), and trims the
  padding (``dist_finalize``).  ``last`` holds the call's per-rank
  counters, kernel launches and solve times; ``launches`` sums each rank's
  kernel launches over calls.  With ``tap_wire`` set, each rank also
  records every call it made into ``torch.distributed`` during the solve
  (``collectives.WireTap``; ``last["wire"]``), and with ``track_peak`` the
  peak bytes its device allocator held above the solve's start
  (``last["peak_bytes"]``, CUDA only): the contract pass reads both.
* :meth:`SolverWorld.run` runs any module-level function on the first P
  ranks with their ``Comm`` (the data-parallel trainer,
  ``train.elastic``); a world built with ``kernels=False`` skips the
  kernel build that the solvers' ranks need.
* :meth:`SolverWorld.run_grid` runs one on the first ranks laid out as a
  grid (``{"pod", "data", "model"}``, ``core.grid``): each gets a
  :class:`GridComm`, its coordinates and one ``Comm`` a group of each axis
  (the ranks that differ on that axis alone; and on pod and data
  together, the batch's axes).  ``dist.new_group`` must be entered by
  every rank of the world, for every group, in one order: the first use
  of a grid makes its groups on all the ranks, then keeps them.

The backend rule: ``"nccl"`` needs one card per rank (rank r computes on
``cuda:r``) and raises for more ranks than cards; ``"gloo"`` lets every rank
share ``device`` (its all-reduce stages device tensors through the host, and
:class:`~repro_torch.core.engine.Comm` stages its ring hops).  Nothing
switches from one to the other.  ``device`` is the card unless the caller
asks for ``"cpu"``.

Ranks run with ``OMP_NUM_THREADS=1`` (and ``GLOO_SOCKET_IFNAME`` /
``NCCL_SOCKET_IFNAME`` set to the loopback device unless the caller set
them: the world lives on one host).  Every collective has the world's
``timeout``, every wait of the parent is bounded, and a rank that fails or
dies tears the world down and raises with its traceback.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from . import collectives, engine
from .grid import as_grid, coords_of, grid_name, grid_size

_LOOPBACK_ENV = {"GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo"}


def _numpy(t):
    return None if t is None else t.detach().cpu().numpy()


def sync_device(device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU): the one
    definition, for every timed region of the world's ranks and the
    launch scripts."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> dict:
    from repro_torch.kernels.gram import launch_counts
    return launch_counts()


# The axis groups of a grid, in the order every rank makes them; axes
# absent from the grid drop out ("pod", "data" is "data" on a 2-D grid).
GRID_GROUPS = (("model",), ("data",), ("pod",), ("pod", "data"))


def _group_members(grid: dict, axes: tuple) -> list:
    """Every group of ranks that differ on ``axes`` alone, each in rank
    order, the groups in the order of the other coordinates."""
    groups: dict = {}
    for rank in range(grid_size(grid)):
        c = coords_of(rank, grid)
        key = tuple(c[a] for a in grid if a not in axes)
        groups.setdefault(key, []).append(rank)
    return list(groups.values())


class GridComm:
    """One rank's handle on a grid of ranks: ``grid`` (``{axis: size}``),
    its ``coords``, its ``rank`` and the grid's ``size``, the ``device``,
    the ``Comm`` of each of its axis groups (:meth:`axis`; ``None`` for an
    axis of one rank: no group, no collective) and ``world``, the ``Comm``
    of all the grid's ranks."""

    def __init__(self, grid: dict, rank: int, device, comms: dict,
                 world: engine.Comm):
        self.grid = grid
        self.rank = rank
        self.size = grid_size(grid)
        self.coords = coords_of(rank, grid)
        self.device = torch.device(device)
        self.world = world
        self._comms = comms

    def axis(self, *axes: str):
        """The ``Comm`` of this rank's group over ``axes`` (those absent
        from the grid dropped), ``None`` where the group is one rank."""
        key = tuple(a for a in axes if a in self.grid)
        return self._comms.get(key)

    @property
    def model(self):
        return self.axis("model")

    @property
    def data(self):
        return self.axis("data")

    @property
    def batch(self):
        """The batch's axes, (pod, data)."""
        return self.axis("pod", "data")

    def comms(self) -> dict:
        """``{name: Comm}`` of every group this rank talks on."""
        out = {"+".join(k): c for k, c in self._comms.items()
               if c is not None}
        out["world"] = self.world
        return out

    def reset(self) -> None:
        for c in self.comms().values():
            c.reset()

    def counters(self) -> dict:
        return {k: c.counters() for k, c in self.comms().items()}

    def host_s(self) -> float:
        """Host seconds inside the rank's collectives, over its groups."""
        return sum(c.host_s() for c in self.comms().values())


class _Rank:
    """One rank's state: its groups, Comms and shards."""

    def __init__(self, rank: int, device: torch.device, groups: dict):
        self.rank = rank
        self.device = device
        self.groups = groups
        self.comms = {}
        self.shards = {}
        self.grids = {}

    def comm(self, P: int) -> engine.Comm:
        if P not in self.comms:
            self.comms[P] = engine.Comm(self.groups[P], self.device)
        return self.comms[P]

    def shard(self, p: dict) -> None:
        """Drop this layout's shard; cut the new one on the first P ranks."""
        axis = p["form"].shard_axes[0]
        self.shards.pop(axis, None)
        if self.rank < p["P"]:
            Xl, _ = p["form"].pad_shards(p["X"], None, p["P"], self.rank)
            self.shards[axis] = (p["key"], Xl.to(self.device))

    def solve(self, p: dict) -> dict:
        P, form, plan = p["P"], p["form"], p["plan"]
        comm = self.comm(P)
        comm.reset()
        key, Xl = self.shards[form.shard_axes[0]]
        if key != p["key"]:
            raise RuntimeError(f"rank {self.rank} holds shard {key}, not "
                               f"{p['key']}")
        dev, dtype = Xl.device, Xl.dtype

        def tensor(a):
            return None if a is None else torch.as_tensor(a, dtype=dtype,
                                                          device=dev)
        idx = torch.as_tensor(p["idx"], device=dev)
        before = _launches()
        sync_device(dev)
        peak = p.get("peak") and dev.type == "cuda"
        if peak:
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        tap = collectives.WireTap() if p.get("tap") else None
        t0 = time.perf_counter()
        with tap or contextlib.nullcontext():
            w, alpha, metrics = self._solve(p, form, plan, comm, Xl, idx,
                                            tensor)
        sync_device(dev)
        wall = time.perf_counter() - t0
        after = _launches()
        return {"w": _numpy(w), "alpha": _numpy(alpha), "metrics": metrics,
                "counters": comm.counters(), "solve_s": wall,
                "launches": {k: after[k] - before[k] for k in after},
                "wire": None if tap is None else tap.counters(),
                "peak_bytes": (torch.cuda.max_memory_allocated(dev) - base
                               if peak else None)}

    def run(self, p: dict):
        """A function of the world's callers on the first P ranks:
        ``fn(comm, device, **kwargs)`` (``comm`` the rank's
        :class:`GridComm` when the call names a grid)."""
        comm = (self.grids[p["grid"]] if p.get("grid")
                else self.comm(p["P"]))
        return p["fn"](comm, self.device, **p["kwargs"])

    def make_grid(self, p: dict) -> None:
        """Make a grid's groups (every rank of the world enters every
        ``new_group``, in one order); a group that is the first k ranks
        reuses the world's group of them, a group of one is none."""
        import torch.distributed as dist
        grid = p["grid"]
        n = grid_size(grid)
        comms = {}
        for axes in GRID_GROUPS:
            key = tuple(a for a in axes if a in grid)
            if not key or key in comms:
                continue
            comms[key] = None
            for ranks in _group_members(grid, key):
                if len(ranks) == 1:
                    continue
                if ranks == list(range(len(ranks))):
                    group = self.groups[len(ranks)]
                else:
                    group = dist.new_group(ranks)
                if self.rank in ranks:
                    comms[key] = engine.Comm(group, self.device)
        if self.rank < n:
            self.grids[grid_name(grid)] = GridComm(
                grid, self.rank, self.device, comms, self.comm(n))

    def _solve(self, p, form, plan, comm, Xl, idx, tensor) -> tuple:
        P = p["P"]
        metrics = None
        if p["kind"] == "single":
            _, yl = form.pad_shards(None, tensor(p["y"]), P, self.rank)
            out = engine.s_step_solve_sharded(
                form, plan, comm, Xl, yl, p["lam"], p["iters"], d=p["d"],
                n=p["n"], idx=idx, x0=tensor(p["x0"]), step0=p["step0"])
            w, alpha = out[0], out[1]
            if plan.guard:
                metrics = out[2]
        else:
            _, ysl = form.pad_shards(None, tensor(p["ys"]), P, self.rank)
            batch = engine.TenantBatch(ys=ysl, lams=p["lams"],
                                       coeffs=p["coeffs"],
                                       x0s=tensor(p["x0s"]))
            w, alpha = engine.s_step_solve_batched_sharded(
                form, plan, comm, Xl, batch, p["iters"], d=p["d"], n=p["n"],
                idx=idx)
        return w, alpha, metrics


def _rank_main(rank: int, size: int, init: str, backend: str, device: str,
               timeout: float, cmd_q, res_q) -> None:
    """A rank's process: join the group, then serve commands until
    ``stop``.  Every reply is ``(rank, "ok" | "error", payload)``."""
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=timeout))
        groups = {size: None}
        for p in range(1, size):      # every rank makes every group, in order
            groups[p] = dist.new_group(list(range(p)))
        state = _Rank(rank, dev, groups)
        res_q.put((rank, "ok", {"pid": os.getpid(), "packages": sorted(
            {name.split(".")[0] for name in sys.modules})}))
    except BaseException:
        res_q.put((rank, "error", traceback.format_exc()))
        return
    while True:
        cmd, payload = cmd_q.get()
        if cmd == "stop":
            break
        try:
            res_q.put((rank, "ok", getattr(state, cmd)(payload)))
        except BaseException:
            res_q.put((rank, "error", traceback.format_exc()))
        # drop the command's tensors now: a CUDA tensor shared by IPC
        # stays allocated in the sender until every receiver lets it go
        payload = None
    with contextlib.suppress(Exception):
        dist.destroy_process_group()


@contextlib.contextmanager
def _child_env():
    """The environment the ranks start with (spawned children inherit it)."""
    saved = dict(os.environ)
    os.environ["OMP_NUM_THREADS"] = "1"
    for k, v in _LOOPBACK_ENV.items():
        os.environ.setdefault(k, v)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def _check_world(n_ranks: int, backend: str, device) -> torch.device:
    """Validate a world's shape; returns its device.  nccl needs one card
    per rank; a CUDA device needs CUDA."""
    engine.check_positive_int("n_ranks", n_ranks)
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend={backend!r} must be 'gloo' or 'nccl'")
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device={device} must be a CPU or a CUDA device")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("backend='nccl' runs on CUDA devices only")
        cards = torch.cuda.device_count()
        if n_ranks > cards:
            raise ValueError(
                f"backend='nccl' needs one card per rank: {n_ranks} ranks, "
                f"{cards} card(s); use backend='gloo' to let ranks share a "
                "card")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the world on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class SolverWorld:
    """``n_ranks`` worker processes joined in one ``torch.distributed``
    group (see the module docstring).  A context manager; :meth:`close`
    stops the ranks."""

    def __init__(self, n_ranks: int, *, backend: str = "gloo",
                 device="cuda", timeout: float = 600.0,
                 kernels: bool = True):
        self.device = _check_world(n_ranks, backend, device)
        self.backend = backend
        self.kernels = kernels
        self.timeout = float(timeout)
        self.size = 0
        self._procs = []
        self._held = {}
        self.last = {}
        self.launches = []
        self.tap_wire = False
        self.track_peak = False
        self._start(n_ranks)

    # -- process management ------------------------------------------------
    def _start(self, n_ranks: int) -> None:
        import torch.multiprocessing as mp
        if self.device.type == "cuda" and self.kernels:
            # the ranks only load the built kernels: no concurrent nvcc
            from repro_torch.kernels.gram import _build
            _build.build_all()
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="solver-world-")
        init = "file://" + os.path.join(self._dir, "rendezvous")
        self._cmd = [ctx.Queue() for _ in range(n_ranks)]
        self._res = ctx.Queue()
        devices = [f"cuda:{r}" if self.backend == "nccl" else str(self.device)
                   for r in range(n_ranks)]
        with _child_env():
            for r in range(n_ranks):
                proc = ctx.Process(
                    target=_rank_main, daemon=True,
                    args=(r, n_ranks, init, self.backend, devices[r],
                          self.timeout, self._cmd[r], self._res))
                proc.start()
                self._procs.append(proc)
        self.size = n_ranks
        self._grids = set()
        self.launches = [dict.fromkeys(_launches(), 0)
                         for _ in range(n_ranks)]
        ready = self._gather(n_ranks)
        self.pids = [o["pid"] for o in ready]
        self.packages = [o["packages"] for o in ready]

    def close(self) -> None:
        """Stop every rank (bounded: a rank that does not stop is killed)."""
        if not self._procs:
            return
        for r, proc in enumerate(self._procs):
            if proc.is_alive():
                with contextlib.suppress(Exception):
                    self._cmd[r].put(("stop", None))
        deadline = time.monotonic() + 30.0
        for proc in self._procs:
            proc.join(max(0.1, deadline - time.monotonic()))
            if proc.is_alive():
                proc.kill()
                proc.join(5.0)
        for q in self._cmd + [self._res]:
            q.close()
            q.cancel_join_thread()
        self._procs = []
        self._held = {}
        self.size = 0
        shutil.rmtree(self._dir, ignore_errors=True)

    def respawn(self, n_ranks: int) -> None:
        """Tear the world down and start one of ``n_ranks`` ranks with the
        same backend, device and timeout (every shard is dropped)."""
        _check_world(n_ranks, self.backend, self.device)
        self.close()
        self._start(n_ranks)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- commands ----------------------------------------------------------
    def _fail(self, msg: str):
        self.close()
        raise RuntimeError(f"SolverWorld: {msg}")

    def _gather(self, P: int) -> list:
        outs = {}
        deadline = time.monotonic() + self.timeout
        while len(outs) < P:
            try:
                rank, status, out = self._res.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                if dead:
                    self._fail(f"rank(s) {dead} exited")
                if time.monotonic() > deadline:
                    self._fail(f"no reply within {self.timeout} s")
                continue
            if status == "error":
                self._fail(f"rank {rank} failed:\n{out}")
            outs[rank] = out
        return [outs[r] for r in range(P)]

    def _call(self, cmd: str, payload: dict, P: int) -> list:
        for r in range(P):
            self._cmd[r].put((cmd, payload))
        return self._gather(P)

    def ranks(self, n_ranks: int) -> "RankGroup":
        """The first ``n_ranks`` ranks as a world of their own for the
        entry points (the counterpart of a sub-mesh)."""
        return RankGroup(self, self._ranks(n_ranks))

    def _ranks(self, n_ranks: int | None) -> int:
        if not self._procs:
            raise RuntimeError("SolverWorld is closed")
        P = self.size if n_ranks is None else n_ranks
        engine.check_positive_int("n_ranks", P)
        if P > self.size:
            raise ValueError(f"n_ranks={P} exceeds the world's {self.size} "
                             "ranks")
        return P

    def _shards(self, form, X: torch.Tensor, P: int) -> str:
        """The key of the ranks' shards of X in ``form``'s layout on P
        ranks, cutting them first (in place of the layout's old shards) if
        the ranks do not hold them."""
        axis = form.shard_axes[0]
        key = f"{id(X)}:{axis}:{P}:{X._version}"
        held = self._held.get(axis)
        if held is not None and held[0] == key:
            return key
        self._held.pop(axis, None)
        self._call("shard", {"key": key, "X": X, "form": form, "P": P},
                   self.size)
        self._held[axis] = (key, X)     # X stays alive: its id stays unique
        return key

    def reset_counts(self) -> None:
        """Zero the summed kernel launches of every rank."""
        self.launches = [dict.fromkeys(d, 0) for d in self.launches]

    def _run(self, form, payload: dict, P: int, d: int, n: int,
             device) -> tuple:
        outs = self._call("solve", payload, P)
        for total, o in zip(self.launches, outs):
            for k, v in o["launches"].items():
                total[k] += v
        rep = 0 if form.shard_axes[0] == 1 else 1   # the replicated half
        halves = [(o["w"], o["alpha"]) for o in outs]
        replicas = [h[rep].tobytes() for h in halves]
        equal = all(r == replicas[0] for r in replicas)
        self.last = {"ranks": P, "replicas_equal": equal,
                     "counters": [o["counters"] for o in outs],
                     "launches": [o["launches"] for o in outs],
                     "solve_s": [o["solve_s"] for o in outs],
                     "wire": [o["wire"] for o in outs],
                     "peak_bytes": [o["peak_bytes"] for o in outs]}
        if not equal:
            self._fail("the replicated iterate differs between ranks")
        local = np.concatenate([h[1 - rep] for h in halves], axis=-1)
        parts = [halves[0][rep], local]
        w, alpha = (torch.from_numpy(a).to(device)
                    for a in (parts if rep == 0 else parts[::-1]))
        return form.dist_finalize(w, alpha, d, n), outs[0]["metrics"]

    def solve(self, formulation, plan: engine.SolverPlan, X: torch.Tensor,
              y: torch.Tensor, lam: float, iters: int,
              generator: torch.Generator | None = None, *,
              idx: torch.Tensor | None = None, x0: torch.Tensor | None = None,
              step0: int = 0, n_ranks: int | None = None):
        """One distributed solve on the first ``n_ranks`` ranks (all by
        default); the arguments as in :func:`engine.s_step_solve`, ``x0``
        the replicated warm start.  Returns ``(w, alpha)`` on X's device,
        with the guard telemetry as a third item when ``plan.guard``."""
        form = engine._resolve_form(formulation)
        P = self._ranks(n_ranks)
        d, n = X.shape
        idx = self._index(form, plan, d, n, iters, generator, idx)
        payload = {"kind": "single", "form": form, "plan": plan,
                   "key": self._shards(form, X, P), "P": P,
                   "d": d, "n": n, "lam": float(lam), "iters": iters,
                   "y": _numpy(y), "idx": idx, "x0": _numpy(x0),
                   "step0": step0, **self._probes()}
        (w, alpha), metrics = self._run(form, payload, P, d, n, X.device)
        return (w, alpha, metrics) if plan.guard else (w, alpha)

    def solve_batched(self, formulation, plan: engine.SolverPlan,
                      X: torch.Tensor, batch: engine.TenantBatch, iters: int,
                      generator: torch.Generator | None = None, *,
                      idx: torch.Tensor | None = None,
                      n_ranks: int | None = None
                      ) -> engine.BatchedSolveResult:
        """T tenant solves sharing one packet reduction per outer step on
        the first ``n_ranks`` ranks; ``batch.tol`` is refused (see
        :func:`engine.s_step_solve_batched_sharded`)."""
        form = engine._resolve_form(formulation)
        engine._check_batched(form, plan, batch)
        if batch.tol is not None:
            raise ValueError(
                "batched sharded solves do not support TenantBatch.tol: "
                "in-step retirement would need a second collective per "
                "outer step; retire between chunks on the local backend")
        P = self._ranks(n_ranks)
        d, n = X.shape
        idx = self._index(form, plan, d, n, iters, generator, idx)
        payload = {"kind": "batched", "form": form, "plan": plan,
                   "key": self._shards(form, X, P), "P": P,
                   "d": d, "n": n, "iters": iters, "ys": _numpy(batch.ys),
                   "lams": batch.lams, "coeffs": batch.coeffs,
                   "x0s": _numpy(batch.x0s), "idx": idx, **self._probes()}
        (ws, alphas), _ = self._run(form, payload, P, d, n, X.device)
        return engine.BatchedSolveResult(
            ws, alphas, torch.ones((batch.tenants,), dtype=torch.bool,
                                   device=X.device), {})

    def run(self, fn, n_ranks: int | None = None, **kwargs) -> list:
        """``fn(comm, device, **kwargs)`` on each of the first ``n_ranks``
        ranks (all by default): ``comm`` is the rank's
        :class:`~repro_torch.core.engine.Comm` on their group.  ``fn`` must
        be importable by the ranks (a module-level function).  Returns the
        ranks' results in rank order."""
        P = self._ranks(n_ranks)
        return self._call("run", {"fn": fn, "P": P, "kwargs": kwargs}, P)

    def run_grid(self, fn, grid, **kwargs) -> list:
        """``fn(comm, device, **kwargs)`` on the first ``prod(grid)`` ranks
        laid out as ``grid`` (``{"pod", "data", "model"}`` or a tuple,
        ``core.grid.as_grid``; rank-major, model fastest): ``comm`` is
        the rank's :class:`GridComm`.  The grid's groups are made on every
        rank of the world at its first use.  Returns the ranks' results in
        rank order."""
        grid = as_grid(grid)
        P = self._ranks(grid_size(grid))
        key = grid_name(grid)
        if key not in self._grids:
            self._call("make_grid", {"grid": grid}, self.size)
            self._grids.add(key)
        return self._call("run", {"fn": fn, "P": P, "grid": key,
                                  "kwargs": kwargs}, P)

    def _probes(self) -> dict:
        return {"tap": self.tap_wire, "peak": self.track_peak}

    @staticmethod
    def _index(form, plan, d, n, iters, generator, idx) -> np.ndarray:
        if idx is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or an explicit idx")
            idx = engine.sample_blocks(generator, form.sample_dim(d, n),
                                       plan.b, iters)
        else:
            engine._check_idx(idx, iters, plan.b)
        return np.asarray(_numpy(torch.as_tensor(idx)), dtype=np.int32)


class RankGroup:
    """The first ``size`` ranks of a :class:`SolverWorld`, with its solve
    API: ``ca_bcd_sharded(world.ranks(2), ...)`` runs on two ranks."""

    def __init__(self, world: SolverWorld, size: int):
        self.world, self.size = world, size

    @property
    def last(self) -> dict:
        return self.world.last

    def solve(self, *args, **kw):
        return self.world.solve(*args, n_ranks=self.size, **kw)

    def solve_batched(self, *args, **kw):
        return self.world.solve_batched(*args, n_ranks=self.size, **kw)

    def run(self, fn, n_ranks: int | None = None, **kwargs) -> list:
        """``SolverWorld.run`` on these ranks (``n_ranks`` must be None or
        the group's size)."""
        if n_ranks not in (None, self.size):
            raise ValueError(f"a group of {self.size} ranks runs on "
                             f"{self.size}, not {n_ranks}")
        return self.world.run(fn, self.size, **kwargs)


def plan_solver_world(n_ranks: int, world: SolverWorld) -> SolverWorld:
    """The elastic re-plan over the survivors (the counterpart of the
    reference's ``train.elastic.plan_solver_mesh``): respawn ``world`` on
    ``n_ranks`` ranks, capped at the cards present for nccl, at least one.
    The formulations' ``shard`` re-cuts the logical operands at any count,
    so a restart is this world plus a warm start."""
    n = max(1, n_ranks)
    if world.backend == "nccl":
        n = min(n, torch.cuda.device_count())
    world.respawn(n)
    return world
