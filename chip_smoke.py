#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's main path -- the single-device s-step solve of CA-BCD
(primal) and CA-BDCD (dual) -- at the full real-sim shape of the paper's
Table 3 (d = 20958 features, n = 72309 points, X = 6.06 GB in f32), through
the four hand-written CUDA kernels K1-K4, and checks each kernel against its
plain PyTorch version on the card.

Phases (any failure raises; nothing is caught):
  1. set-up: versions, the card's name and power limit, the kernel build;
  2. each kernel against its plain version at the solve's shapes (f32) and at
     a small f64 shape, with its device time beside its bound, the plain
     version's time and a library call's time;
  3. the solves at real-sim size: CA(16) against classical, the kernel path
     against impl="ref", the objective going down, the launch counts;
  4. f64 exactness through the kernels at the 8x-cut real-sim shape: CA(s)
     against classical for s in {3, 16} with a ragged tail.

Run from the repository root:  python3 chip_smoke.py [--iters N] [--seed N]
Needs one CUDA card; exits non-zero without one.  Prints a JSON line of
kernel measurements, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402

from repro_torch import core  # noqa: E402
from repro_torch.data import (PAPER_DATASETS, PAPER_DATASETS_FULL,  # noqa: E402
                              make_regression)
from repro_torch.kernels import gram as gk  # noqa: E402
from repro_torch.kernels.gram import _build  # noqa: E402
from repro_torch.launch.timing import KERNEL_NAMES, device_ms, wall_ms  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the f32 / f64 rates
# of the CUDA cores outside the tensor cores (the kernels use no tensor cores).
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"torch.float32": 67e12, "torch.float64": 34e12}
SECTOR = 32                     # bytes moved per scattered element read
# Kernel against plain version, relative Frobenius error of each output and
# of G's cross terms alone (entries of two different indices, which the sums
# of squares on the diagonal and at duplicate pairs cannot mask).  The f32
# gate sits well above the f32 readings (about 2e-7); the script checks that
# it sits below the cross-term error of the plain version in TF32.
TOL_KERNEL = {"torch.float32": 1e-5, "torch.float64": 1e-12}
# The keys of a kernel's entry in the printed "kernels" line.
LINE_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
# CA(s) against classical, and kernels against impl="ref", after 1024 f32
# inner iterations: both sides round differently at every packet (the split
# contraction's order depends on m), so the iterates drift apart by a few
# hundred f32 ulps.
TOL_SOLVE_F32 = 1e-4
TOL_SOLVE_F64 = 1e-10           # CA(s) against classical in f64


def log(msg: str) -> None:
    print(msg, flush=True)


def rel(a, b) -> float:
    """Relative Frobenius distance of a from b."""
    return float((a - b).double().norm() / b.double().norm().clamp_min(1e-300))


def cross_terms(G, flat):
    """G with the entries of equal indices (the diagonal and the duplicate
    pairs, all sums of squares) set to zero."""
    return G.masked_fill(flat[:, None] == flat[None, :], 0.0)


def blocked_flat(gen, n_total: int, b: int, blocks: int):
    """``blocks`` blocks of ``b`` distinct indices each, with duplicates
    across blocks forced in: the index pattern of one outer step."""
    idx = core.sample_blocks(gen, n_total, b, blocks)
    for k in range(1, blocks):
        prev = idx[k - 1, 0]
        if not bool((idx[k] == prev).any()):
            idx[k, -1] = prev              # a duplicate across blocks
    return idx.reshape(-1).contiguous()


def ragged_flat(gen, n_total: int, m: int):
    """m indices, not a multiple of any tile, with one duplicate."""
    perm = torch.randperm(n_total, generator=gen, device=gen.device)[:m]
    perm[-1] = perm[0]
    return perm.to(torch.int32).contiguous()


def bound(kind: str, m: int, uniq: int, K: int, dtype) -> dict:
    """Least time for the function on these inputs: each input read once
    (only the sampled rows / columns of X), each output written once, against
    the operations at the CUDA-core rate of ``dtype``."""
    isz = 8 if str(dtype) == "torch.float64" else 4
    if kind == "packet":
        nbytes = (uniq * K + K + m * m + m) * isz + 4 * m
        flops = 2 * (m * (m + 1) // 2 * K + m * K)
    else:
        nbytes = (uniq * K + m + K) * isz + 4 * m
        flops = 2 * m * K
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[str(dtype)] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_kernels(X, gen, tag: str, ms: tuple, reps: int,
                  main_m: dict) -> dict:
    """Phase 2 on one X: every kernel against its plain version for each m in
    ``ms``; at ``main_m[kind]`` also the timings.  Returns per-kernel records
    at the main shapes."""
    d, n = X.shape
    tol = TOL_KERNEL[str(X.dtype)]
    specs = [  # kernel, info, plain, layout, samples, contraction, kind
        (gk.gram_packet_sampled_rows, gk.ROWS_PACKET,
         gk.gram_packet_sampled_ref, d, n, "packet", "rows"),
        (gk.panel_apply_rows, gk.ROWS_APPLY, gk.panel_apply_ref, d, n,
         "apply", "rows"),
        (gk.gram_packet_sampled_cols, gk.COLS_PACKET,
         gk.gram_packet_sampled_cols_ref, n, d, "packet", "cols"),
        (gk.panel_apply_cols, gk.COLS_APPLY, gk.panel_apply_cols_ref, n, d,
         "apply", "cols"),
    ]
    out = {}
    for kern, info, plain, S, K, kind, layout in specs:
        for m in ms:
            flat = (blocked_flat(gen, S, 8, m // 8) if m % 8 == 0
                    else ragged_flat(gen, S, m))
            vec = torch.randn((K if kind == "packet" else m,), generator=gen,
                              device=X.device, dtype=X.dtype)
            got = kern(X, flat, vec)
            want = plain(X, flat, vec)
            torch.cuda.synchronize()
            got = got if kind == "packet" else (got,)
            want = want if kind == "packet" else (want,)
            errs = [rel(g, w) for g, w in zip(got, want)]
            if kind == "packet":
                errs.append(rel(cross_terms(got[0], flat),
                                cross_terms(want[0], flat)))
            max_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
            sym = (float((got[0] - got[0].T).abs().max()) if kind == "packet"
                   else 0.0)
            log(f"  {tag} {info.name:26s} m={m:4d}: rel err "
                + ("G, r, G cross terms " if kind == "packet" else "")
                + " ".join(f"{e:.2e}" for e in errs)
                + f" (tol {tol:.0e}), max abs {max_abs:.2e}, "
                f"asym {sym:.1e}")
            if not all(math.isfinite(e) and e <= tol for e in errs):
                raise AssertionError(f"{info.name} disagrees with its plain "
                                     f"version at m={m}: {errs}")
            if sym != 0.0:
                raise AssertionError(f"{info.name}: G is not symmetric")
            if m != main_m.get(kind):
                continue
            uniq = int(torch.unique(flat).numel())
            rec = {"name": info.name, "route": "cuda", "source": info.source,
                   "replaces": info.replaces, "max_abs_err": max_abs,
                   "m": m, "dtype": str(X.dtype).replace("torch.", "")}
            if kind == "packet" and X.dtype == torch.float32:
                rec["tf32_cross_err"] = tf32_cross_err(X, flat, vec, plain,
                                                       want[0])
                log(f"    the plain version in TF32: G cross terms rel err "
                    f"{rec['tf32_cross_err']:.2e}")
                if not rec["tf32_cross_err"] > tol:
                    raise AssertionError(f"the f32 gate {tol} would pass a G "
                                         f"computed in TF32")
            names = KERNEL_NAMES["packet" if kind == "packet"
                                 else f"{layout}_apply"]
            rec["ms"] = device_ms(lambda: kern(X, flat, vec), reps, names)
            rec["wrapper_ms"] = wall_ms(lambda: kern(X, flat, vec), reps)
            rec["plain_ms"] = device_ms(lambda: plain(X, flat, vec), reps)
            rec["library_ms"] = library_ms(X, flat, vec, kind, layout, reps)
            rec.update(bound(kind, m, uniq, K, X.dtype))
            if layout == "cols":
                # scattered reads: one 32-byte sector per sampled element.  A
                # model of the traffic, not a measurement: it stays out of the
                # printed kernels line.
                rec["sector_ms"] = uniq * K * SECTOR / HBM_BYTES_PER_S * 1e3
            log(f"    device {rec['ms']:.4f} ms (wrapper incl. host checks "
                f"{rec['wrapper_ms']:.4f}), plain {rec['plain_ms']:.4f}, "
                f"library {rec['library_ms']:.4f}, bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})"
                + (f", sector bound {rec['sector_ms']:.4f} ms"
                   if "sector_ms" in rec else ""))
            out[info.name] = rec
    return out


def tf32_cross_err(X, flat, vec, plain, G) -> float:
    """The cross-term error of the plain packet with its products rounded to
    TF32, against the f32 ``G``: what the f32 gate has to be able to see."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        G_tf32 = plain(X, flat, vec)[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return rel(cross_terms(G_tf32, flat), cross_terms(G, flat))


def library_ms(X, flat, vec, kind: str, layout: str, reps: int):
    """One cuBLAS call computing the kernel's function from the sampled panel
    gathered beforehand (the gather is left out of the time): [G | r] as one
    matrix product, or the apply as one matrix-vector product."""
    fl = flat.long()
    if layout == "rows":
        Y = X.index_select(0, fl)                     # (m, n)
    else:
        Y = X.index_select(1, fl).T.contiguous()      # (m, d)
    if kind == "packet":
        rhs = torch.cat([Y.T, vec[:, None]], dim=1).contiguous()
        return device_ms(lambda: torch.mm(Y, rhs), reps)
    Yt = Y.T.contiguous()
    return device_ms(lambda: torch.mv(Yt, vec), reps)


def run_solves(X, y, lam, idx_p, idx_d, iters: int,
               stats: dict) -> dict:
    """Phase 3: the main path, counted, then the impl="ref" comparisons.
    Returns the launch counts of the main path; fills ``stats``."""
    d, n = X.shape
    b = idx_p.shape[1]
    runs = {}
    gk.reset_launch_counts()                          # main path starts here
    for form, solve, idx in (("primal", core.ca_bcd, idx_p),
                             ("dual", core.ca_bdcd, idx_d)):
        for s in (1, 16):
            before = {k.name: k.launches for k in gk.KERNELS}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = solve(X, y, lam, b, s, iters, idx=idx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = {k.name: k.launches - before[k.name] for k in gk.KERNELS}
            outer = -(-iters // s)
            packet, apply = (("gram_packet_sampled_rows", "panel_apply_rows")
                             if form == "primal" else
                             ("gram_packet_sampled_cols", "panel_apply_cols"))
            want = {k.name: 0 for k in gk.KERNELS}
            want[packet], want[apply] = outer, iters
            if ran != want:
                raise AssertionError(f"{form} s={s}: launches {ran}, "
                                     f"expected {want}")
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"  {form:6s} s={s:2d}: {wall:.3f} s, "
                f"{wall / outer * 1e3:.3f} ms/outer step, "
                f"{iters / wall:.1f} inner it/s, peak mem {peak:.2f} GiB, "
                f"launches {ran}")
            stats[f"{form}_s{s}"] = {"wall_s": wall, "iters": iters,
                                     "ms_per_outer": wall / outer * 1e3,
                                     "inner_it_per_s": iters / wall,
                                     "peak_gib": peak}
            runs[(form, s)] = res
    counts = {k.name: k.launches for k in gk.KERNELS}   # main path ends here

    for form, solve, idx in (("primal", core.ca_bcd, idx_p),
                             ("dual", core.ca_bdcd, idx_d)):
        # The primal's exact block minimisation lowers the objective at every
        # step; the dual's primal objective need not fall monotonically, so
        # it is held only below its start, the objective at w = 0.
        f0 = float(0.5 / n * (y @ y))
        hist = runs[(form, 1)].history["objective"]
        first, last = float(hist[0]), float(hist[-1])
        down = (last < first < f0) if form == "primal" else (last < f0)
        if not (math.isfinite(last) and down):
            raise AssertionError(f"{form}: objective did not go down: "
                                 f"{f0} -> {first} -> {last}")
        ca = rel(runs[(form, 16)].w, runs[(form, 1)].w)
        before = [k.launches for k in gk.KERNELS]
        t0 = time.perf_counter()
        ref = solve(X, y, lam, b, 16, iters, idx=idx, impl="ref")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if [k.launches for k in gk.KERNELS] != before:
            raise AssertionError("impl='ref' launched a CUDA kernel")
        kr = rel(runs[(form, 16)].w, ref.w)
        log(f"  {form:6s}: objective {f0:.6e} -> {first:.6e} -> "
            f"{last:.6e}; |w_CA16 - w_classical|/|w| {ca:.2e}, "
            f"|w_cuda - w_ref|/|w| {kr:.2e} (tol {TOL_SOLVE_F32:.0e}); "
            f"impl=ref s=16 solve {wall:.3f} s")
        stats[f"{form}_s16_ref"] = {"wall_s": wall, "iters": iters}
        stats[f"{form}_agreement"] = {"ca16_vs_classical": ca,
                                      "cuda_vs_ref": kr}
        if not (ca <= TOL_SOLVE_F32 and kr <= TOL_SOLVE_F32):
            raise AssertionError(f"{form}: solves disagree ({ca}, {kr})")
    return counts


def where_time_goes(X, y, lam, idx_p, idx_d, iters: int,
                    stats: dict) -> None:
    """Phase 3b: per solve, the device's busy time from a profiler trace
    against the wall time of the same solve run unprofiled, and the kernels
    that take the device's time."""
    from torch.profiler import ProfilerActivity, profile
    b = idx_p.shape[1]
    for form, solve, idx in (("primal", core.ca_bcd, idx_p[:iters]),
                             ("dual", core.ca_bdcd, idx_d[:iters])):
        for s in (1, 16):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve(X, y, lam, b, s, iters, idx=idx)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                solve(X, y, lam, b, s, iters, idx=idx)
                torch.cuda.synchronize()
            per_name = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    per_name[e.name] = (per_name.get(e.name, 0.0)
                                        + e.time_range.elapsed_us() / 1e3)
            busy = sum(per_name.values())
            top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
            log(f"  {form:6s} s={s:2d}, {iters} iters: wall {wall:.1f} ms, "
                f"device busy {busy:.1f} ms, idle {1 - busy / wall:.1%}")
            for name, ms in top:
                log(f"      {ms:9.3f} ms  {name[:90]}")
            stats[f"profile_{form}_s{s}"] = {
                "wall_ms": wall, "busy_ms": busy, "idle": 1 - busy / wall,
                "top": [[name[:120], ms] for name, ms in top]}


def exactness_f64(data, gen, iters: int) -> None:
    """Phase 4: CA(s) == classical in f64 through the kernels."""
    X, y, _ = data
    lam = 1e-6 * float(torch.linalg.norm(X) ** 2)
    d, n = X.shape
    for form, solve, dim in (("primal", core.ca_bcd, d),
                             ("dual", core.ca_bdcd, n)):
        idx = core.sample_blocks(gen, dim, 8, iters)
        base = solve(X, y, lam, 8, 1, iters, idx=idx)
        for s in (3, 16):
            ca = solve(X, y, lam, 8, s, iters, idx=idx)
            e = rel(ca.w, base.w)
            ea = rel(ca.alpha, base.alpha)
            log(f"  f64 {form:6s} s={s:2d} (iters % s = {iters % s}): "
                f"|dw|/|w| {e:.2e}, |dalpha|/|alpha| {ea:.2e} "
                f"(tol {TOL_SOLVE_F64:.0e})")
            if not (e <= TOL_SOLVE_F64 and ea <= TOL_SOLVE_F64):
                raise AssertionError(f"f64 {form} s={s}: CA(s) != classical")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=1024,
                    help="inner iterations of each real-sim solve")
    ap.add_argument("--reps", type=int, default=50,
                    help="calls per kernel timing")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    # -- 1. set-up ---------------------------------------------------------
    log("== 1. set-up")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    log(f"  nvidia-smi: {smi}")
    built = _build.build_all()
    log(f"  kernel build: {built['seconds']:.1f} s ({len(built['log'])} "
        f"sources compiled)")
    for src, text in built["log"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {src}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    X, y, _ = make_regression(gen, PAPER_DATASETS_FULL["real-sim"],
                              torch.float32, device=dev)
    torch.cuda.synchronize()
    log(f"  real-sim f32 X {tuple(X.shape)} ({X.numel() * 4 / 1e9:.2f} GB) "
        f"generated in {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    lam = 1e-6 * float(torch.linalg.norm(X) ** 2)
    log(f"  lambda = 1e-6 ||X||_F^2 = {lam:.6e}")
    t0 = time.perf_counter()
    cut = make_regression(gen, PAPER_DATASETS["real-sim"], torch.float64,
                          device=dev)
    torch.cuda.synchronize()
    log(f"  real-sim 8x cut f64 X {tuple(cut[0].shape)} generated in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 2. kernels against their plain versions ---------------------------
    log("== 2. kernels against their plain versions")
    main_m = {"packet": 128, "apply": 8}       # sb at s = 16, b at any s
    records = check_kernels(X, gen, "f32", (8, 128, 77), args.reps, main_m)
    check_kernels(cut[0], gen, "f64", (8, 128, 77), 0, {})

    # -- 3. the solves at real-sim size ------------------------------------
    log(f"== 3. real-sim solves, b = 8, iters = {args.iters} (the dual's "
        "metrics make one pass over X per inner iteration)")
    d, n = X.shape
    idx_p = core.sample_blocks(gen, d, 8, args.iters)
    idx_d = core.sample_blocks(gen, n, 8, args.iters)
    stats = {}
    counts = run_solves(X, y, lam, idx_p, idx_d, args.iters, stats)
    log("== 3b. where a solve's time goes (profiler trace)")
    where_time_goes(X, y, lam, idx_p, idx_d, min(64, args.iters), stats)
    del X, y

    # -- 4. f64 exactness --------------------------------------------------
    log("== 4. f64 exactness through the kernels (8x-cut real-sim)")
    exactness_f64(cut, gen, 200)

    kernels = []
    for info in gk.KERNELS:
        rec = dict(records[info.name])
        rec["launches"] = counts[info.name]
        if rec["launches"] == 0:
            raise AssertionError(f"{info.name} never ran on the main path")
        kernels.append(rec)
    if args.json:                   # every record, with its extra keys
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": smi, "torch": torch.__version__,
             "cuda": torch.version.cuda, "kernels": kernels,
             "solves": stats}, indent=1))
    print(json.dumps({"kernels": [{k: rec[k] for k in LINE_KEYS}
                                  for rec in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
