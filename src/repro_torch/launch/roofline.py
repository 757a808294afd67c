"""Roofline analysis over the dry-run records, the twin of
``repro.launch.roofline``, at the H100's constants.

Hardware model (NVIDIA H100 SXM data sheet, dense, at 700 W; cited, not
measured: ``core.cost_model``):
    peak = 989 TFLOP/s bf16 a card (tensor cores)
    HBM  = 3.35 TB/s a card
    link = 450 GB/s each way a card (NVLink, ``cost_model.H100_NVLINK``)

Terms per (arch x shape x world) cell, seconds a step, per rank:
    compute    = flops / peak                   [probe-extrapolated]
    memory     = bytes accessed / HBM           [probe-extrapolated]
    collective = collective operand bytes / link
                 (the ring model's link bytes, 2 (P - 1) / P x operand,
                 beside it)

beside the port's own measurement: ``measured_s``, the probe's
extrapolated step time, and ``measured_over_bound``.  The collective term
models NVLink; a world of gloo ranks sharing one card moves its bytes
through the host instead, and each row says which wire its record ran on.
Flops are ``torch.utils.flop_counter``'s (matmul-type operations) and bytes
each aten op's inputs and outputs (``launch.dryrun.CostMode``), where the
reference reads XLA's cost analysis.  The constants are keywords, so the
reference's TPU v5e numbers can be passed in to compare the two analyses.

MODEL_FLOPS = 6 N D for training (2 N D for inference cells), N = active
params, D = tokens per step; the model / counted ratio flags remat and
replicated work.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import SHAPES, get_config, n_active_params, n_params
from repro_torch.core.cost_model import (H100_BF16_FLOPS,
                                         H100_HBM_BYTES_PER_S, H100_NVLINK)

PEAK_FLOPS = H100_BF16_FLOPS          # bf16 / card
HBM_BW = H100_HBM_BYTES_PER_S         # bytes/s / card
LINK_BW = 4 / H100_NVLINK.beta        # bytes/s / card each way (450e9)
HBM_CAPACITY = 80e9                   # bytes / card (the data sheet's 80 GB)


def model_flops(cfg, shape) -> float:
    n_act = n_active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_act * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n_act * tokens


def load_cells(art_dir: str) -> dict:
    cells = {}
    for path in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        key = (rec["arch"], rec["shape"], rec["mesh"])
        slot = "probe" if rec.get("probe") else "base"
        cells.setdefault(key, {})[slot] = rec
    return cells


def analyze_cell(arch: str, shape_name: str, mesh: str, base: dict,
                 probe: dict | None, *, peak_flops: float = PEAK_FLOPS,
                 hbm_bw: float = HBM_BW, link_bw: float = LINK_BW,
                 hbm_capacity: float = HBM_CAPACITY) -> dict:
    """One cell's roofline terms (the reference's keys, ``fits`` against
    the card's memory in place of ``fits_16gb``, and the port's measured
    time beside the bound)."""
    cfg = get_config(arch.split("+")[0])   # "+tag" = optimized variant rows
    shape = SHAPES[shape_name]
    chips = base.get("chips", 256)
    out = {"arch": arch, "shape": shape_name, "mesh": mesh,
           "status": base["status"]}
    if base["status"] != "ok":
        out["reason"] = base.get("reason", base.get("error", ""))
        return out
    measured_s = None
    if probe and probe.get("status") == "ok":
        ex = probe["extrapolated_per_device"]
        flops_dev = ex["flops"]
        bytes_dev = ex["bytes_accessed"]
        coll_operand_dev = ex["coll_operand_bytes"]
        coll_link_dev = ex["coll_link_bytes"]
        coll_count = ex["coll_count"]
        measured_s = ex.get("step_s")
        out["cost_source"] = "probe-extrapolated"
    elif base.get("cost_analysis") is not None:
        # the reference's rolled compile (loop bodies counted once)
        flops_dev = base["cost_analysis"]["flops_per_device"]
        bytes_dev = base["cost_analysis"]["bytes_accessed_per_device"]
        coll_operand_dev = base["collectives"]["operand_bytes"]
        coll_link_dev = base["collectives"]["link_bytes"]
        coll_count = base["collectives"]["count"]
        out["cost_source"] = base["cost_analysis"].get(
            "source", "rolled (loop bodies counted once)")
    else:
        flops_dev = None
        out["cost_source"] = "not measured: " + (
            f"probe {probe['status']}: {probe.get('reason', probe.get('error', ''))}"
            if probe else "no probe")
    mem = base["memory_analysis"]
    temp = mem["temp_bytes"]
    hbm_bytes = (mem["argument_bytes"] + (temp or 0)
                 + mem["output_bytes"])
    capacity = mem.get("device_memory_bytes") or hbm_capacity
    out.update({
        "chips": chips,
        "model_flops": model_flops(cfg, shape),
        "hbm_gb_per_device": hbm_bytes / 1e9,
        "temp_measured": temp is not None,
        "fits": hbm_bytes < capacity,
        "n_params": n_params(cfg),
        "n_active": n_active_params(cfg),
        "wire": base.get("wire", "a TPU mesh's ICI"),
    })
    if flops_dev is None:
        out["advice"] = "measure first: no probe of this cell ran"
        return out
    compute_s = flops_dev / peak_flops
    memory_s = bytes_dev / hbm_bw
    coll_s = coll_operand_dev / link_bw          # prompt convention
    coll_ring_s = coll_link_dev / link_bw        # ring model (physical)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    mf = out["model_flops"]
    useful_s = mf / (chips * peak_flops)
    bound_s = max(terms.values())
    out.update({
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "collective_ring_s": coll_ring_s,
        "coll_count": coll_count,
        "dominant": dominant,
        "hlo_flops_global": flops_dev * chips,
        "model_over_hlo": mf / max(flops_dev * chips, 1.0),
        "roofline_fraction": useful_s / max(bound_s, 1e-30),
        "bound_s": bound_s,
        "measured_s": measured_s,
        "measured_over_bound": (None if measured_s is None
                                else measured_s / max(bound_s, 1e-30)),
    })
    out["advice"] = _advice(out)
    return out


def _advice(c: dict) -> str:
    d = c["dominant"]
    if d == "collective":
        return ("reduce wire bytes: bf16 collectives, fused packets, or "
                "move the bottleneck axis to sequence/expert sharding")
    if d == "memory":
        return ("cut HBM traffic: tighter remat policy, fused loss (no "
                "materialized logits), larger arithmetic intensity per pass")
    if c["model_over_hlo"] < 0.25:
        return ("compute-bound but mostly waste: replicated attention or "
                "remat overhead dominates -- reshard (context parallelism / "
                "head padding) before buying flops")
    return ("compute-bound and mostly useful: raise tensor-core "
            "utilization (bf16 products with f32 sums in place of f32 "
            "upcasts, fewer eager launches)")


def _num(x, fmt: str) -> str:
    return "not measured" if x is None else format(x, fmt)


def table(cells: dict, mesh: str = "p1", **constants) -> str:
    rows = []
    header = ("| arch | shape | status | compute s | memory s | collective s "
              "| dominant | model / counted flops | roofline frac "
              "| measured ms | measured / bound | GB a rank | fits |")
    rows.append(header)
    rows.append("|" + "---|" * 13)
    for (arch, shape, m), slots in sorted(cells.items()):
        if m != mesh or "base" not in slots:
            continue
        c = analyze_cell(arch, shape, m, slots["base"], slots.get("probe"),
                         **constants)
        if c["status"] == "skipped":
            rows.append(f"| {arch} | {shape} | skipped: {c['reason'][:60]} "
                        "| -- | -- | -- | -- | -- | -- | -- | -- | -- | -- |")
            continue
        if c["status"] != "ok":
            rows.append(f"| {arch} | {shape} | FAILED | | | | | | | | | | |")
            continue
        fits = "y" if c["fits"] else "N"
        if not c["temp_measured"]:
            fits += " (no temp)"
        if "compute_s" not in c:
            rows.append(f"| {arch} | {shape} | ok, {c['cost_source'][:70]} "
                        f"| -- | -- | -- | -- | -- | -- | -- | -- "
                        f"| {c['hbm_gb_per_device']:.1f} | {fits} |")
            continue
        ms = None if c["measured_s"] is None else c["measured_s"] * 1e3
        rows.append(
            f"| {arch} | {shape} | ok | {c['compute_s']:.3e} "
            f"| {c['memory_s']:.3e} | {c['collective_s']:.3e} "
            f"| {c['dominant']} | {c['model_over_hlo']:.3f} "
            f"| {c['roofline_fraction']:.3f} | {_num(ms, '.1f')} "
            f"| {_num(c['measured_over_bound'], '.2f')} "
            f"| {c['hbm_gb_per_device']:.1f} | {fits} |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default="artifacts/dryrun")
    ap.add_argument("--mesh", default="p1")
    ap.add_argument("--json-out", default="artifacts/roofline.json")
    args = ap.parse_args()
    cells = load_cells(args.artifacts)
    print(table(cells, args.mesh))
    results = []
    for (arch, shape, m), slots in sorted(cells.items()):
        if "base" in slots:
            results.append(analyze_cell(arch, shape, m, slots["base"],
                                        slots.get("probe")))
    os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
    with open(args.json_out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"\n[roofline] wrote {args.json_out}")


if __name__ == "__main__":
    main()
