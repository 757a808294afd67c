"""Kernel plan pass: every contraction chunk the port can dispatch, checked
against the Hopper kernels' limits without launching a kernel.

The packet kernels (K1 / K3, ``dense_tile``) and the matvecs (K6 / K5,
``matvec_ring``) cut the contraction K into ``ceil(K / bk)`` chunks; the
chunk comes from ``tuning.pick_tiles`` (a table entry, else the default
pick) or from an explicit :class:`~repro_torch.kernels.gram.PacketPlan`.
A bad chunk would fail at the launch on the card, or silently change a
packet's sums.  This pass checks every chunk of the live table (built-ins
plus whatever ``register_table`` / ``REPRO_TORCH_GRAM_TUNING`` merged), the
default picks over a grid of shapes that holds the real-sim solves and
their shards, and any plan a caller hands in:

* smem-budget: the kernels' dynamic shared memory, from their own host
  geometries (``gram_kernel.dense_geometry``,
  ``sampled_kernel.matvec_geometry``; ``cost_model.kernel_smem_bytes``),
  fits ``SMEM_PER_BLOCK`` (kernel-geometry: a shape or dtype the kernels
  are not built for);
* chunk-alignment: ``bk`` is a positive multiple of ``tuning.BK``, the
  shared-memory stage;
* split-count: ``ceil(K / bk)`` is at most ``tuning.MAX_SPLITS``
  (gridDim.y);
* bucket-consistency: a table entry's chunk is no longer than its own
  K bucket (longer, it is one split for every shape of the bucket: a
  mis-keyed entry);
* index-arithmetic: m fits the kernels' int sample count, the tile order's
  ``ti << 16 | tj`` packing holds the tile rows, and a bucket's element
  count fits the 64-bit offsets;
* residual-order: at every table key, the chunk the packet kernel (K1 /
  K3) runs at equals the matvec's (K6 / K5), so the identity
  K5 / K6 == K3 / K1's r (which keeps batched solves equal to single ones
  bit for bit) cannot be broken by a table.  Both read one lookup, so a
  table in the shipped format keeps it; the check asks each kernel's own
  geometry, so it catches a lookup that drifts apart.
"""
from __future__ import annotations

import torch

from .report import PassReport, Violation

INT32_MAX = 2**31 - 1
TILE_ROWS_MAX = 2**15          # dense_tiles packs ti << 16 | tj in an int32
TENANTS = (1, 8)               # matvec launches checked at each shape
# The default-pick grid: sample counts of the solves (b = 8 at s = 1, the
# contract sweep's sb = 8, a ragged 77, sb = 128 at s = 16, 256) against
# contractions of the tests' tiny problems, the real-sim shape (d = 20958,
# n = 72309) and its four-rank shards (n / 4 = 18078, d / 4 = 5240).
GRID_M = (1, 8, 77, 128, 256)
GRID_K = {"rows": (32, 100, 18078, 72309), "cols": (16, 100, 5240, 20958)}
DTYPES = ("float32", "float64")


def _dtype(name: str):
    dt = getattr(torch, name, None)
    return dt if isinstance(dt, torch.dtype) else None


def check_chunk(m: int, K: int, dtype_name: str, layout: str, bk,
                subject: str) -> list:
    """Contract checks for one dispatch: an (m samples, K contraction)
    packet and its matvecs in ``layout`` at chunk ``bk`` (None: the live
    pick, table or default).  Returns violations."""
    from repro_torch.kernels.gram import tuning
    from repro_torch.kernels.gram.gram_kernel import dense_geometry
    from repro_torch.kernels.gram.sampled_kernel import (SMEM_PER_BLOCK,
                                                         matvec_geometry)
    out = []
    dtype = _dtype(dtype_name)
    if layout not in tuning.LAYOUTS or dtype is None:
        return [Violation("plan-key", subject,
                          f"layout {layout!r} / dtype {dtype_name!r} is not "
                          f"one of {tuning.LAYOUTS} / a torch dtype")]
    chunk = tuning.pick_tiles(m, K, dtype, layout) if bk is None else bk
    if chunk < 1 or chunk % tuning.BK:
        return [Violation("chunk-alignment", subject,
                          f"bk={chunk} is not a positive multiple of the "
                          f"{tuning.BK}-step shared-memory stage")]
    splits = -(-K // chunk)
    if splits > tuning.MAX_SPLITS:
        out.append(Violation(
            "split-count", subject,
            f"bk={chunk} cuts K={K} into {splits} splits > gridDim.y's "
            f"{tuning.MAX_SPLITS}"))
        return out
    if m > INT32_MAX:
        out.append(Violation("index-arithmetic", subject,
                             f"m={m} exceeds the kernels' int sample count"))
        return out
    geoms = {}
    try:
        geoms["packet"] = dense_geometry(m, K, dtype, bk, source=layout)
        for T in TENANTS:
            geoms[f"matvec T={T}"] = matvec_geometry(m, K, T, dtype, layout,
                                                     bk)
    except (ValueError, TypeError) as e:
        check = ("smem-budget" if "shared memory" in str(e)
                 else "kernel-geometry")
        out.append(Violation(check, subject,
                             f"the kernels refuse (m={m}, K={K}, "
                             f"{dtype_name}, {layout}, bk={chunk}): {e}"))
        return out
    for name, g in geoms.items():
        if g.smem > SMEM_PER_BLOCK:
            out.append(Violation(
                "smem-budget", subject,
                f"{name} needs {g.smem} bytes of shared memory a block, "
                f"budget {SMEM_PER_BLOCK}"))
    tile_rows = -(-m // geoms["packet"].bm)
    if tile_rows >= TILE_ROWS_MAX:
        out.append(Violation(
            "index-arithmetic", subject,
            f"{tile_rows} tile rows of {geoms['packet'].bm} overflow the "
            f"tile order's 16-bit row field"))
    packet_chunk = geoms["packet"].chunk
    for name, g in geoms.items():
        if g.chunk != packet_chunk:
            out.append(Violation(
                "residual-order", subject,
                f"{name} runs at chunk {g.chunk}, the packet at "
                f"{packet_chunk}: the matvec no longer sums in the packet's "
                f"residual order"))
    return out


def _edges(bucket: int) -> tuple:
    """The least and the greatest size of a power-of-two bucket."""
    return tuple(sorted({max(1, bucket // 2 + 1), bucket}))


def check_table_entry(key: tuple, bk: int, subject: str) -> list:
    """One live table entry: its own bucket, then every dispatch at the
    bucket's edge shapes (resolved through the table, as the kernels
    resolve them)."""
    mb, kb, dtype_name, layout = key
    out = []
    if bk > kb:
        out.append(Violation(
            "bucket-consistency", subject,
            f"bk={bk} outgrows its own K bucket {kb}: every shape of the "
            f"bucket runs one split"))
    if mb > INT32_MAX or mb * kb >= 2**63:
        out.append(Violation(
            "index-arithmetic", subject,
            f"bucket ({mb}, {kb}) overflows the kernels' index types"))
        return out
    for m in _edges(mb):
        for K in _edges(kb):
            out.extend(check_chunk(m, K, dtype_name, layout, None,
                                   f"{subject} at (m={m}, K={K})"))
    return out


def check_plan(plan, m: int, K: int, dtype_name: str = "float32",
               layout: str = "rows", subject: str | None = None) -> list:
    """Validate one explicit :class:`PacketPlan` at an (m, K) dispatch
    (``bk=None`` defers to the table, which is swept anyway)."""
    from repro_torch.kernels.gram.ops import IMPLS
    subject = subject or (f"PacketPlan(impl={plan.impl}, bk={plan.bk}) at "
                          f"(m={m}, K={K}, {dtype_name}, {layout})")
    out = []
    if plan.impl is not None and plan.impl not in IMPLS:
        out.append(Violation("plan-impl", subject,
                             f"impl {plan.impl!r} not in {IMPLS}"))
    out.extend(check_chunk(m, K, dtype_name, layout, plan.bk, subject))
    return out


def run_plan_pass(extra_plans=()) -> PassReport:
    """Sweep the live table, the default picks over the grid, and
    ``extra_plans`` (``(plan, m, K, dtype_name, layout)`` tuples)."""
    from repro_torch.kernels.gram.tuning import table_entries

    rep = PassReport("plan")
    for key, bk in table_entries():
        subject = rep.case("table[{},{},{},{}] -> bk={}".format(*key, bk))
        rep.violations.extend(check_table_entry(key, bk, subject))
    for dtype_name in DTYPES:
        for layout, Ks in GRID_K.items():
            for m in GRID_M:
                for K in Ks:
                    subject = rep.case(f"default[m={m}, K={K}, {dtype_name}, "
                                       f"{layout}]")
                    rep.violations.extend(check_chunk(
                        m, K, dtype_name, layout, None, subject))
    for plan, m, K, dtype_name, layout in extra_plans:
        subject = rep.case(f"plan[{plan!r} at (m={m}, K={K}, {dtype_name}, "
                           f"{layout})]")
        rep.violations.extend(check_plan(plan, m, K, dtype_name, layout,
                                         subject))
    return rep
