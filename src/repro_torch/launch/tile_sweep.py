"""Sweep the free launch geometry of the Gram kernels on the card, at the
solve's shapes (real-sim: d = 20958, n = 72309, f32).

* ``packet``: the contraction chunk ``bk`` of the packet kernels K1 and K3,
  per m; prints the device time of one packet and its block count, with the
  default pick of ``tuning.pick_tiles`` marked.
* ``gather``: the row-sampled packet K1 at its pick, m = 128 and m = 8, on
  rows of X in several patterns -- random (the solver's), random sorted,
  consecutive, 7 apart (one 2 MB page apart at real-sim), and random with
  only m/2 or m/4 distinct rows -- beside K7 on the random rows gathered
  beforehand: what the row addresses cost the gathered tile.
* ``cols``: the dual's column kernels at the solve's m = 8 and m = 128, on
  three random index sets each: the column-sampled packet K3 at every
  geometry it is built for (``gram_kernel.COLS_BUILT``, K3's own chunk),
  and the column apply K4 at every segment width it is built for
  (``sampled_colmajor.apply_cols_geometry``); timed warm (K3 also
  its ``dense_tile`` alone) and cold as the matvecs.
* ``apply``: block size, columns a thread and load batch of the row apply K2
  (``sampled_kernel.apply_geometry``), every geometry it is built for, at
  the solve's m = 8 and at CG's shape (flat = arange(d)); timed warm and
  cold as the matvecs.
* ``matvec``: rows per block, ring depth and stage length of the matvec
  kernels K5 and K6 (``sampled_kernel.matvec_geometry``; combinations that
  need more shared memory than a block has are skipped), with the chunk
  fixed by the packet,
  at m = 128 (s = 16, b = 8) and m = 8 for T = 1 and T = 8 tenants, and K6 at
  CG's shape (flat = arange(d)); each timed with L2 warm (calls back to
  back, profiler) and cold (``timing.l2_flush`` before each call, CUDA
  events).
* ``dense``: tile edge, micro-tile, ring depth and stage length of the
  dense Gram kernels K7 / K8 (``gram_kernel.dense_geometry``), every
  geometry they are built for, at K8's real-sim shape (CholeskyQR's
  operand, 20958 x 93267) and K7's gathered panel (m = 128, K = 72309);
  for K8 also the strip height of the tile order.  K8 is timed with CUDA
  events (seconds a call: warm, then cold after an L2 flush), K7 as the
  matvecs.
* ``bf16``: the bf16 packets on the tensor cores (``mma_tile``): K1, K7 and
  K3 at m = 128 and 8 at every ring they are built for
  (``gram_kernel.MMA_BUILT``) and at chunks around their pick, the tile and
  the reduce pass also apart; K1 also on consecutive rows.  Each ring held
  to the pick under torch.equal at its chunk.

Every geometry's output must equal the default's under ``torch.equal``:
the geometry cuts the work, never a sum.  The data are Gaussian: no
kernel's work depends on the values, but the card's power draw does, and
with it the clock under the power cap (PERF.md, K8).

Run on a GPU:  PYTHONPATH=src python -m repro_torch.launch.tile_sweep
               [--only packet|gather|cols|apply|matvec|dense|bf16]
               [--reps N]
"""
from __future__ import annotations

import argparse
import itertools

import torch

from repro_torch.data.regression import check_device
from repro_torch.kernels import gram as gk
from repro_torch.kernels.gram import gram_kernel as gkk
from repro_torch.kernels.gram import sampled_colmajor as sc
from repro_torch.kernels.gram import sampled_kernel as sk
from repro_torch.kernels.gram import tuning
from repro_torch.launch.timing import (KERNEL_NAMES, device_ms, event_ms,
                                       l2_flush)

CHUNKS = (256, 512, 1024, 1536, 2048, 3072, 4096, 8192)


def sweep_packets(X, g, reps: int) -> list:
    d, n = X.shape
    rows = []
    for kern, layout, S, K in ((gk.gram_packet_sampled_rows, "rows", d, n),
                               (gk.gram_packet_sampled_cols, "cols", n, d)):
        u = torch.randn((K,), generator=g, device=X.device)
        for m in (8, 128):
            flat = torch.randperm(S, generator=g, device=X.device)[:m].to(
                torch.int32)
            auto = tuning.pick_tiles(m, K, X.dtype, layout)
            for bk in sorted(set(CHUNKS) | {auto}):
                ms = device_ms(lambda: kern(X, flat, u, bk=bk), reps,
                               KERNEL_NAMES[f"{layout}_packet"])
                blocks = tuning.lower_tiles(m) * -(-K // bk)
                mark = "  <- default" if bk == auto else ""
                print(f"{kern.__name__:26s} m={m:4d} bk={bk:5d} "
                      f"blocks={blocks:5d}: {ms:.4f} ms{mark}", flush=True)
                rows.append(("packet", layout, m, bk, ms))
    return rows


def sweep_gather(X, g, reps: int) -> list:
    """K1 at its pick on rows of X in several patterns, warm and cold,
    beside K7 on the random rows gathered beforehand."""
    d, n = X.shape
    flush = l2_flush(X.device)
    u = torch.randn((n,), generator=g, device=X.device)
    out = []
    for m in (128, 8):
        rnd = torch.randperm(d, generator=g, device=X.device)[:m]
        Y = X[rnd].contiguous()
        pats = {"random": rnd, "sorted": rnd.sort().values,
                "consecutive": torch.arange(m, device=X.device),
                "7 apart": 7 * torch.arange(m, device=X.device) % d,
                "m/2 distinct": rnd[:m // 2].repeat(2),
                "m/4 distinct": rnd[:m // 4].repeat(4)}
        cases = [("K7 on the gathered random rows",
                  lambda: gk.gram_packet_dense(Y, u), KERNEL_NAMES["dense"])]
        for name, rows in pats.items():
            flat = rows.to(torch.int32).contiguous()
            geom = sk.rows_packet_geometry(m, n, X.dtype)
            cases.append((f"K1 on {name} rows",
                          lambda f=flat, geom=geom: gkk.launch_dense(
                              gk.ROWS_PACKET, X, u, geom, 1.0, 0.0, None, f),
                          KERNEL_NAMES["rows_packet"]))
        for name, launch, names in cases:
            warm = device_ms(launch, reps, names)
            tile = device_ms(launch, reps, ("dense_tile",))
            cold = event_ms(launch, reps, flush)
            print(f"gather m={m:4d} {name:32s}: warm {warm:.4f} ms (tile "
                  f"{tile:.4f}), cold {cold:.4f} ms", flush=True)
            out.append(("gather", m, name, warm, tile, cold))
    return out


def cols_packet_launcher(X, flat, u, geom=None):
    """A call that launches K3 on (X, flat, u) at ``geom`` (default: the
    wrapper's pick), without the wrapper's operand checks, which wait on
    the device: for timing."""
    geom = geom or sc.cols_packet_geometry(flat.shape[0], X.shape[0],
                                           X.dtype)
    return lambda: gkk.launch_dense(sc.COLS_PACKET, X, u, geom, 1.0, 0.0,
                                    None, flat)


def cols_apply_launcher(X, flat, v, geom=None):
    """A call that launches K4 on (X, flat, v) at ``geom`` (default: the
    wrapper's pick), without the wrapper's operand checks."""
    geom = geom or sc.apply_cols_geometry(flat.shape[0], X.shape[0], X.dtype)
    return lambda: sc.launch_apply_cols(X, flat, v, geom, 1.0)


def sweep_cols(X, g, reps: int, sets: int = 3) -> list:
    """K3 at every geometry, and K4 at every segment width, it is built
    for, at the solve's m = 8 and 128, on ``sets``
    random index sets each (the means and each set's time are printed);
    every geometry held to the pick under torch.equal; warm and cold."""
    d, n = X.shape
    flush = l2_flush(X.device)
    out = []

    def timed(kind, m, label, launches, names, auto):
        warm = [device_ms(f, reps, names) for f in launches]
        cold = [event_ms(f, reps, flush) for f in launches]
        extra = ""
        if kind == "cols_packet":
            tile = [device_ms(f, reps, ("dense_tile",)) for f in launches]
            extra = f" (tile {sum(tile) / sets:.4f})"
        mark = "  <- default" if auto else ""
        print(f"{kind} m={m:4d} {label}: warm {sum(warm) / sets:.4f} ms"
              f"{extra}, cold {sum(cold) / sets:.4f} ms; warm by set "
              + " ".join(f"{t:.4f}" for t in warm) + mark, flush=True)
        out.append((kind, m, label, sum(warm) / sets, sum(cold) / sets))

    for m in (8, 128):
        flats = [torch.randperm(n, generator=g, device=X.device)[:m].to(
            torch.int32) for _ in range(sets)]
        u = torch.randn((d,), generator=g, device=X.device)
        v = torch.randn((m,), generator=g, device=X.device)
        auto = sc.cols_packet_geometry(m, d, X.dtype)
        want = [cols_packet_launcher(X, f, u, auto)() for f in flats]
        for bm, tm, tn, st, q in gkk.COLS_BUILT[X.dtype]:
            geom = sc.cols_packet_geometry(m, d, X.dtype, bm=bm,
                                           micro=(tm, tn), stages=st, steps=q)
            launches = [cols_packet_launcher(X, f, u, geom) for f in flats]
            for launch, w in zip(launches, want):
                if not all(torch.equal(a, b) for a, b in zip(launch(), w)):
                    raise AssertionError(f"cols_packet m={m}: {geom} changed "
                                         f"a sum")
            timed("cols_packet", m,
                  f"chunk={geom.chunk:5d} bm={bm:3d} stages={st:2d} "
                  f"steps={q:2d} blocks={geom.grid[0] * geom.grid[1]:5d} "
                  f"smem={geom.smem:6d}", launches,
                  KERNEL_NAMES["cols_packet"], geom == auto)
        auto = sc.apply_cols_geometry(m, d, X.dtype)
        want = [cols_apply_launcher(X, f, v, auto)() for f in flats]
        for seg in sc.APPLY_COLS_SEGS:
            if seg < min(m, 32):
                continue
            geom = sc.apply_cols_geometry(m, d, X.dtype, seg=seg)
            launches = [cols_apply_launcher(X, f, v, geom) for f in flats]
            if not all(torch.equal(launch(), w)
                       for launch, w in zip(launches, want)):
                raise AssertionError(f"cols_apply m={m}: {geom} changed a "
                                     f"sum")
            timed("cols_apply", m,
                  f"seg={seg:2d} blocks={geom.blocks:5d}",
                  launches, KERNEL_NAMES["cols_apply"], geom == auto)
    return out


def apply_launcher(X, flat, v, geom=None):
    """A call that launches K2 on (X, flat, v) at ``geom`` (default: the
    wrapper's pick), without the wrapper's operand checks, which wait on
    the device: for timing."""
    geom = geom or sk.apply_geometry(flat.shape[0], X.shape[1], X.dtype)
    return lambda: sk.launch_apply(X, flat, v, geom, 1.0)


def sweep_applies(X, g, reps: int) -> list:
    """Every (threads, cols, batch) K2 is built for, at the solve's m = 8
    and at CG's shape, each held to the pick under torch.equal."""
    d, n = X.shape
    flush = l2_flush(X.device)
    out = []
    for m in (8, d):
        flat = (torch.arange(d, dtype=torch.int32, device=X.device)
                if m == d else torch.randperm(d, generator=g,
                                              device=X.device)[:m].to(
                                                  torch.int32))
        v = torch.randn((m,), generator=g, device=X.device)
        auto = sk.apply_geometry(m, n, X.dtype)
        want = apply_launcher(X, flat, v, auto)()
        for threads, (cols, batch) in itertools.product(
                sk.APPLY_THREADS, sk.APPLY_BUILT[X.dtype]):
            geom = sk.apply_geometry(m, n, X.dtype, threads=threads,
                                     cols=cols, batch=batch)
            launch = apply_launcher(X, flat, v, geom)
            if not torch.equal(launch(), want):
                raise AssertionError(f"rows_apply m={m}: {geom} changed a "
                                     f"sum")
            n_reps = max(1, reps // 5) if m == d else reps
            warm = device_ms(launch, n_reps, KERNEL_NAMES["rows_apply"])
            cold = event_ms(launch, n_reps, flush)
            mark = "  <- default" if geom == auto else ""
            print(f"rows_apply m={m:5d} threads={threads:3d} cols={cols} "
                  f"batch={batch:2d} blocks={geom.blocks:5d}: warm "
                  f"{warm:.4f} ms, cold {cold:.4f} ms{mark}", flush=True)
            out.append(("apply", m, threads, cols, batch, warm, cold))
    return out


def matvec_launcher(X, flat, t, layout: str, geom=None):
    """A call that launches K6 (``layout`` "rows") or K5 ("cols") on
    (X, flat, t) at ``geom`` (default: the wrappers' pick), without the
    wrappers' operand checks, which wait on the device: for timing."""
    d, n = X.shape
    K = n if layout == "rows" else d
    tenants = 1 if t.dim() == 1 else t.shape[0]
    geom = geom or sk.matvec_geometry(flat.shape[0], K, tenants, X.dtype,
                                      layout)
    if layout == "rows":
        return lambda: sk.launch_matvec(sk.ROWS_MATVEC, "rows_matvec",
                                        sk.MATVEC_ARGS, X, flat, t, (n,),
                                        geom, 1.0)
    return lambda: sk.launch_matvec(sc.COLS_MATVEC, "cols_matvec",
                                    sc.MATVEC_ARGS, X, flat, t, (d, n), geom,
                                    1.0)


def sweep_matvecs(X, g, reps: int) -> list:
    """Every (rows, stages, steps) the kernel is built for, at each main
    shape."""
    d, n = X.shape
    cases = [(layout, m, T) for layout in ("rows", "cols") for m in (128, 8)
             for T in (1, 8)] + [("rows", d, 1)]
    out = []
    flush = l2_flush(X.device)
    for layout, m, T in cases:
        S, K = (d, n) if layout == "rows" else (n, d)
        flat = (torch.arange(d, dtype=torch.int32, device=X.device)
                if m == d else torch.randperm(S, generator=g,
                                              device=X.device)[:m].to(
                                                  torch.int32))
        t = torch.randn((T, K), generator=g, device=X.device)
        auto = sk.matvec_geometry(m, K, T, X.dtype, layout)
        want = matvec_launcher(X, flat, t, layout, auto)()
        for r, s, q in itertools.product(sk.MV_ROWS, sk.MV_STAGES,
                                         sk.MV_STEPS):
            try:
                geom = sk.matvec_geometry(m, K, T, X.dtype, layout, rows=r,
                                          stages=s, steps=q)
            except ValueError:              # more shared memory than a block
                continue
            launch = matvec_launcher(X, flat, t, layout, geom)
            if not torch.equal(launch(), want):
                raise AssertionError(f"{layout} m={m} T={T}: rows={r} "
                                     f"stages={s} steps={q} changed a sum")
            n_reps = max(1, reps // 5) if m == d else reps
            warm = device_ms(launch, n_reps, KERNEL_NAMES["matvec"])
            cold = event_ms(launch, n_reps, flush)
            mark = "  <- default" if geom == auto else ""
            print(f"{layout}_matvec m={m:5d} T={T} chunk={auto.chunk:5d} "
                  f"rows={r:2d} stages={s} steps={q:3d} blocks="
                  f"{geom.grid[0] * geom.grid[1]:5d} smem={geom.smem:6d}: "
                  f"warm {warm:.4f} ms, cold {cold:.4f} ms{mark}",
                  flush=True)
            out.append(("matvec", layout, m, T, r, s, q, warm, cold))
    return out


def dense_launcher(A, u, geom):
    """A call that launches K7 (``u`` given) or K8 on A at ``geom``,
    without the wrappers' operand checks."""
    info = gk.DENSE_GRAM if u is None else gk.DENSE_PACKET
    return lambda: gkk.launch_dense(info, A, u, geom, 1.0, 0.0, None)


def dense_geometries(m: int, K: int, dtype) -> list:
    """Every geometry dense_tile is built for at (m, K), the pick first."""
    auto = gkk.dense_geometry(m, K, dtype)
    every = [gkk.dense_geometry(m, K, dtype, bm=bm, micro=(tm, tn),
                                stages=st, steps=q)
             for (bm, tm, tn), (st, q) in itertools.product(
                 gkk.DENSE_TILES[dtype], gkk.DENSE_RINGS[dtype])]
    return [auto] + [geom for geom in every if geom != auto]


def sweep_dense(g, reps: int, d: int, n: int) -> list:
    """K8 at (d, n + d) and K7 at (128, n): every geometry against the
    pick under torch.equal, warm and cold; K8 also per strip height."""
    dev = g.device
    flush = l2_flush(dev)
    out = []
    for name, m, K, residual in (("dense_gram", d, n + d, False),
                                 ("dense_packet", 128, n, True)):
        A = torch.randn((m, K), generator=g, device=dev)
        u = torch.randn((K,), generator=g, device=dev) if residual else None
        geoms = dense_geometries(m, K, A.dtype)
        auto = geoms[0]
        nt = -(-m // auto.bm)
        if not residual:
            geoms += [auto._replace(group=grp) for grp in (4, 8, 32, nt)
                      if grp != auto.group]
        want = dense_launcher(A, u, auto)()
        for geom in geoms:
            launch = dense_launcher(A, u, geom)
            got = launch()
            if not all(torch.equal(a, b) for a, b in zip(got, want)
                       if a is not None):
                raise AssertionError(f"{name} {geom} changed a sum")
            del got
            if residual:
                warm = device_ms(launch, reps, KERNEL_NAMES["dense"])
                cold = event_ms(launch, reps, flush)
            else:
                warm = event_ms(launch, 1)
                cold = event_ms(launch, 1, flush)
            mark = "  <- default" if geom == auto else ""
            print(f"{name} m={m:5d} K={K} chunk={geom.chunk:5d} "
                  f"bm={geom.bm:3d} micro={geom.tm}x{geom.tn} "
                  f"stages={geom.stages} steps={geom.steps:2d} "
                  f"group={geom.group:3d} blocks="
                  f"{geom.grid[0] * geom.grid[1]:5d} smem={geom.smem:6d}: "
                  f"warm {warm:.4f} ms, cold {cold:.4f} ms{mark}",
                  flush=True)
            out.append(("dense", name, m, K, geom.bm, geom.tm, geom.tn,
                        geom.stages, geom.steps, geom.group, warm, cold))
        del A, u, want
    return out


BF16_CHUNKS = {("rows", 128): (288, 1152), ("rows", 8): (160, 576),
               ("cols", 128): (160, 480, 1632), ("cols", 8): (96, 320)}


def sweep_bf16(X, g, reps: int) -> list:
    """The bf16 packets K1 / K7 (rows) and K3 (cols) at every built ring of
    their tile edge and at chunks around the pick; tile and reduce apart."""
    from repro_torch.launch.bf16_packets import NAMES
    Xb = X.to(torch.bfloat16)
    d, n = Xb.shape
    out = []
    for m in (128, 8):
        rows = torch.randperm(d, generator=g, device=X.device)[:m]
        cols = torch.randperm(n, generator=g, device=X.device)[:m]
        u = torch.randn((n,), generator=g, device=X.device).to(Xb.dtype)
        uc = torch.randn((d,), generator=g, device=X.device).to(Xb.dtype)
        Y = Xb[rows].contiguous()
        runs = [("K1", "rows", Xb, rows.to(torch.int32), u, n),
                ("K1 consecutive rows", "rows", Xb,
                 torch.arange(m, dtype=torch.int32, device=X.device), u, n),
                ("K7", "dense", Y, None, u, n),
                ("K3", "cols", Xb, cols.to(torch.int32), uc, d)]
        for name, source, A, flat, vec, K in runs:
            layout = "cols" if source == "cols" else "rows"
            info = {"rows": sk.ROWS_PACKET_BF16, "dense": gk.DENSE_PACKET_BF16,
                    "cols": sc.COLS_PACKET_BF16}[source]
            auto = gkk.dense_geometry(m, K, Xb.dtype, source=source)
            for bk in (auto.chunk,) + BF16_CHUNKS[(layout, m)]:
                want = None
                for bm, st, q in gkk.MMA_BUILT[source]:
                    if bm != auto.bm:
                        continue
                    geom = gkk.dense_geometry(m, K, Xb.dtype, bk, stages=st,
                                              steps=q, source=source)

                    def launch(geom=geom):
                        return gkk.launch_dense(info, A, vec, geom, 1.0, 0.0,
                                                None, flat)
                    got = launch()
                    if want is None:
                        want = got
                    elif not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError(f"{name} m={m} {geom} changed a "
                                             f"sum")
                    total = device_ms(launch, reps, NAMES)
                    tile = device_ms(launch, reps, ("mma_tile",))
                    red = (device_ms(launch, reps, ("dense_reduce",))
                           if geom.splits > 1 else 0.0)
                    mark = "  <- default" if geom == auto else ""
                    print(f"bf16 {name:20s} m={m:4d} chunk={bk:5d} "
                          f"splits={geom.splits:4d} bm={bm:3d} stages={st} "
                          f"steps={q:3d} smem={geom.smem:6d}: {total:.4f} ms "
                          f"(tile {tile:.4f}, reduce {red:.4f}){mark}",
                          flush=True)
                    out.append(("bf16", name, m, bk, bm, st, q, total, tile,
                                red))
    return out


def main(d: int = 20958, n: int = 72309, reps: int = 20, seed: int = 0,
         only: str | None = None) -> list:
    dev = check_device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    if only in (None, "packet", "gather", "cols", "apply", "matvec",
                "bf16"):
        X = torch.randn((d, n), generator=g, device=dev)
        if only in (None, "packet"):
            rows += sweep_packets(X, g, reps)
        if only in (None, "gather"):
            rows += sweep_gather(X, g, reps)
        if only in (None, "cols"):
            rows += sweep_cols(X, g, reps)
        if only in (None, "apply"):
            rows += sweep_applies(X, g, reps)
        if only in (None, "matvec"):
            rows += sweep_matvecs(X, g, reps)
        if only in (None, "bf16"):
            rows += sweep_bf16(X, g, reps)
        del X
    if only in (None, "dense"):
        rows += sweep_dense(g, reps, d, n)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", choices=("packet", "gather", "cols", "apply",
                                       "matvec", "dense", "bf16"),
                    default=None)
    args = ap.parse_args()
    main(reps=args.reps, only=args.only)
