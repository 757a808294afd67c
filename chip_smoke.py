#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's paths -- the single-device s-step solve of CA-BCD
(primal) and CA-BDCD (dual), the tenant-batched engine (primal, dual,
proximal), the continuous-batching solve service, the baselines (CG,
CholeskyQR and TSQR), the accelerated solve with the health guards,
fault injection and the supervised restart, and the sharded and pipelined
backends on a world of ranks -- at the full real-sim shape of the paper's Table 3
(d = 20958 features, n = 72309 points, X = 6.06 GB in f32), through the
eight hand-written CUDA kernels K1-K8, and checks each kernel against its
plain PyTorch version on the card.

Phases (any failure raises; nothing is caught):
  1. set-up: versions, the card's name and power limit, the kernel build;
  2. each kernel against its plain version at the solve's shapes (f32) and at
     the 8x-cut f64 shape, with its device time beside its bound, the plain
     version's time and a library call's time (for K1-K6 also PyTorch's
     gather of the sampled panel that the library call starts from,
     ``gather_ms``, outside the printed kernels line); the packets K1 / K3
     timed at the solve's m = 128 and m = 8; the matvecs K5/K6 also equal
     to K3/K1's r and their T-tenant launch to T single launches
     (torch.equal), K3 equal to K7 on its gathered transposed panel
     X[:, flat]^T at K3's chunk (torch.equal), and K3, K4, K5/K6 and their
     library calls timed twice, L2 warm (calls back to back) and L2 cold (a
     256 MB write before each call), K1's and K3's tile and reduce passes
     also apart; the dense K7 / K8 on a gathered panel, K7 equal to K1 on
     the same indices and K8 to K7's G (torch.equal); K2 and K6 at CG's
     shape (flat = arange(d)), both also L2 cold;
  3. the single solves at real-sim size (counted): CA(16) against
     classical, the kernel path against impl="ref", the objective going
     down, the launch counts; 3b. the device-idle share from a trace, with
     each of the port's kernels' time and launches in it;
  4. f64 exactness through the kernels at the 8x-cut real-sim shape: CA(s)
     against classical for s in {3, 16} with a ragged tail;
  5. the batched engine at real-sim size (counted): 8 tenants with mixed
     lambda, primal, dual and proximal, each tenant equal to its single
     solve (torch.equal); ms per outer step at T in {1, 8, 32}; the
     device-idle share;
  6. the solve service at real-sim size (counted): 24 requests through 16
     slots, primal then dual, each ticket equal to a single solve replayed
     over the index chunks of its steps (torch.equal); solves/s;
  7. the baselines at real-sim size: K8 at CholeskyQR's full operand
     against its plain version and an f64 product, timed; then (counted)
     the CholeskyQR ridge solve through K8, CG through K2 / K6 and through
     the dense products, CG's history, TSQR and CholeskyQR in f64 on the
     8x-cut real-sim (primal) and news20 (dual), K7 on a gathered panel;
     each solve against the direct one; the solve's time split; the
     device-idle share of a CG solve;
  8. accelerated, guards, faults and recovery at real-sim size (counted):
     the accelerated solve at beta = 0 equal to the primal (torch.equal)
     and at beta = 0.9 against impl="ref", timed beside the primal; guarded
     clean primal and dual solves equal to unguarded ones (torch.equal, same
     launches); the fault matrix {nan_packet, bitflip, drop_shard} x
     {primal, dual} at s = 16, each tripping at its step with its reason
     bit and finishing on the s = 1 tail near the clean objective; the
     jitter rescue of a singular duplicate-row block at lam = 0; the
     supervised restart after a device loss (f32, and f64 on the 8x cut)
     against the uninterrupted solve, with the snapshot's write time and
     size; 8b. the guard's and the momentum's cost: guarded and
     accelerated primal solves against unguarded ones at s = 1 and 16 in
     profiler traces;
  9. the sharded and pipelined backends at real-sim size on a world of four
     gloo ranks sharing the card (counted, launches summed over the ranks):
     primal and dual at s in {1, 16}, on the all-reduce and on the ring,
     each against the local solve on the same stream, with H all-reduces
     and no hop, or 2 (P - 1) H hops and no all-reduce, and the replicated
     iterate the same bytes on every rank; the batched primal (T = 8,
     s = 16) against its single sharded solves on four ranks and, under
     torch.equal, on two; guarded clean solves equal to unguarded ones;
     the fault matrix on shard 1; then the supervised restart after a
     device loss onto 3 survivors (f32, and f64 on the 8x cut) and one
     NCCL rank.  Wire times are gloo's, host-staged, with the ranks on one
     card;
 2c. (inside phase 2) the bf16 packets K1 / K3 / K7 (tensor cores) on the
     real-sim X cast to bf16 at m = 128 and 8: within the reference's 2e-2
     of the bf16 plain version and 1e-4 of the f64 one on the upcast
     operand (the f32 kernel on it logged beside), K1 equal to K7 on
     X[flat] and K3 to K7 on X[:, flat]^T at K3's chunk, G to G^T and two
     runs alike (torch.equal), timed beside their bound (bf16 inputs, f32
     outputs, the card's bf16 tensor-core rate) and, with --parent, beside
     another commit's design in turns; then one packet of each at each m
     through the public entry points (counted: the "bf16 packets" path);
 10. the contract engine on the card (counted, launches summed over the
     parent and the ranks): (a) the kernels' shared-memory budget against
     the card's opt-in limit, and the plan pass; (b) the contract pass on
     four gloo ranks sharing the card (every registered solver, impl "ref"
     and "cuda"), then panel-free and operand-copy-free at real-sim size
     through K1-K6 (the allocator's peak against the sampled panel and the
     operand, in this process and on each rank); (c) the cost model's ms
     per outer step against phases 3 and 9 (the gloo wire refitted to this
     run's all-reduces); (d) the snapshot cadence from this run's snapshot
     write and step time;
 11. the LM at llama3.2-3b's published width (28 layers, d_model 3072,
     GQA 24 / 8 heads, vocab 128256, random weights from --seed), after
     phases 1-10's operands are freed: (a) prefill of 63 tokens and one
     decode step against forward (B = 2, rtol / atol 1e-3) and the
     engine's greedy tokens (2 slots, 2 prompts, 8 tokens) against the
     step-by-step greedy forward, in f32 at 2 layers and in f64 at 28,
     chunked attention against the materialised softmax at a ragged
     length; (c) the LM probe: features X 3072 x 1024 in f64 from the f32
     model, K3 / K4 first held against their plain versions on that X at
     m = b and sb, then (counted: the "lm probe" path) BDCD and CA-BDCD
     (b = 32, s = 10, 200 iterations) on one index stream through
     K3 / K4, CA-BDCD within 1e-8 of BDCD; (b) in bf16
     (6.43 GB of weights), bf16 against f32 last-position logits on eight
     prompts, then 8 requests of 16-200 prompt tokens x 32 new tokens
     through 4 slots: prefill ms per bucket, decode ms a step beside the
     1.918 ms weight-read bound, tokens/s, the decode's device-idle share
     (profiler trace) and the allocator's peak;
 12. the other LM bodies, random weights from --seed (plain torch, as in
     the reference: no kernel; counted, the "lm families" path, all
     zero): (a) mamba2-370m at its published width and depth (48 layers,
     d_model 1024, 32 heads of 64, state 128, chunk 256): the chunked SSD
     scan against the token recurrence, prefill + decode against forward
     and the engine against the greedy oracle on prompts of distinct
     tokens, in f32 and f64, then bf16 serving (8 requests of 256 / 512
     tokens x 32 new through 4 slots); (b) phi3.5-moe-42b at its width,
     gates at MOE_GATE_LAYERS layers in f32 and f64 with the drop
     fraction and aux loss, bf16 serving at MOE_SERVE_LAYERS layers; (c)
     seamless-m4t-large-v2 at its width and depth with S / 4 encoder
     frames: gates in f32 at 2 + 2 layers and in f64 at 24 + 24 (prefill
     + decode against forward, a greedy decode_step loop against the
     greedy oracle), then a bf16 greedy loop of 4 rows; (d)
     jamba-1.5-large's hybrid interleave at its reduced widths, f32 and
     f64 gates.  Each serving run reports tok/s, decode ms a step beside
     its weight- and state-read bound, the decode's idle share and the
     allocator's peak;
 13. training, random weights from --seed (plain torch, as in the
     reference: no kernel; counted, the "train" path, all zero): (a)
     llama3.2-3b at its published width cut to 2 layers in f64, B = 2,
     S = 64: loss_fn's gradient tree on the card against the CPU's and a
     finite difference along a random direction; (b) one make_train_step
     step there, card against CPU; (c) its full config (28 layers, bf16
     weights, f32 master, remat "full") at 2 x 2048 tokens a step through
     Trainer.run on the TokenStream: ms a step, tok/s, the share of the
     bf16 dense rate, the AdamW update's ms, the allocator's peak and the
     idle share of a traced step; (d) microbatches 2 against 1 in f32
     at 8 layers; (e) the cpu-small preset's 200 steps through
     launch/train.py (the loss falls) and exact resume from a checkpoint
     in deterministic mode; (f) the elastic restart of granite-3-2b
     reduced from 4 gloo ranks sharing the card to 2, against one rank, in
     bf16 and f32, the same restart of phi3.5-moe reduced in f32 with its
     experts sharded over the ranks, and an MoE config refused on 3 ranks
     (E = 4);
 14. on four gloo ranks sharing the card (plain torch, as in the
     reference, except (d) and (e)): (a) flash-decoding
     (decode_attention_seqsharded) at llama3.2-3b's decode width (B = 4,
     H = 24 / 8, Dh = 128) over decode_32k's 32768 positions, ragged pos
     (first shard, a shard's last key, the next shard's first, the last),
     against decode_attention on the whole cache in f32 (1e-5) and bf16
     (1e-2): two all-reduces a call, under a quarter of the cache's bytes;
     (b) llama3.2-3b at full width cut to 2 layers, f32: prefill of 63
     tokens, then 8 greedy decode steps with the cache sequence-sharded
     over the ranks against the local decode_step (tokens equal, logits
     1e-3, 2 all-reduces an attention layer a step, ms a step); (c) the
     LM dry run (launch/dryrun.py) of every arch x applicable shape on one
     rank with its probe at full width (two depths x two row cuts,
     counted and timed, extrapolated) and the analytic full-depth record,
     llama3.2-3b's train_4k and decode_32k also on the four ranks, the
     roofline tables at the H100's cited peaks, failed == 0; (d)
     solver_dryrun --tenants 8 --verify 4: H all-reduces a batched solve
     on every rank (K1-K6 on the ranks); (e) launch/lasso.py through K1 /
     K2 (counted: the "lasso" path), s = 20 within 1e-8 of s = 1 and the
     support recovered;
 15. experts sharded over four gloo ranks sharing the card (plain torch
     and collectives, as the reference's jnp MoE: no kernel; counted, the
     "experts" path, all zero), random weights from --seed, f32 unless
     said: (a) one MoE block at dbrx's width (d 6144, d_ff 10752, 16
     experts, top-4; 12.7 GB of experts) and at jamba-1.5-large's (8192,
     24576, 16, top-2; 38.7 GB) at the published capacity 1.25, 4 ranks x
     512 tokens with a shared offset on the tokens (hot experts: slots
     drop), the expert-parallel output against the single-process block
     on the same weights and tokens (EP_TOL), its routing (each rank's
     rows routed as the rank routes them) and drop fraction equal, the
     experts' bmm on an (E / P, C, D) slice against the (E, C, D) call
     (torch.equal or not, reported), all-to-alls a call, bytes a call and
     host ms inside them; (b) dbrx at its width cut to EP_DECODE_LAYERS
     layers (capacity 4.0, no drops, as phase 12's gates): prefill +
     decode steps on the ranks (replicated tokens)
     against forward (LM_TOL) and against the one-process decode bit for
     bit, or, traced tensor by tensor, parting first at a decode step's
     expert products with the bmm witness at its capacity; the engine's
     greedy tokens on the ranks equal to the one-rank engine's; then bf16
     decode ms a step on the ranks against local beside the weight-read
     bounds; the same gate against forward in f64 in one process (62 GB
     of weights); (c) phi3.5-moe at its width cut
     to EP_TRAIN_LAYERS layer at capacity 1.0 (slots drop): one train step
     on the ranks against the
     same step on one rank (loss, aux loss, drop fraction, grad norm, each
     master leaf), ms a step, host ms in the collectives and each rank's
     allocator peak; (d) the dry run's MoE train cells on 4 ranks (phase
     14c: probed, or skipped for memory) and dbrx's and jamba's analytic
     records at 4 and 16 ranks;
 16. the reference's production layout on a grid of four gloo ranks
     sharing the card (plain torch and collectives), llama3.2-3b at its
     published width cut to GRID_LAYERS layers (GRID_ZERO1_LAYERS in (a),
     whose replicated world holds four whole states), f32, on phase 14's
     world: (a) a (4, 1) grid,
     ZeRO-1 alone: every rank's blocks of the state after GRID_STEPS
     Trainer steps the same bytes as its cut of the replicated
     data-parallel world's (SHA-256 a leaf), every master block moved
     by them, each rank's optimizer bytes a quarter of the replicated; (b) a (2, 2) grid, tensor parallelism
     over 'model' and ZeRO-1 over 'data', against the same step in one
     process (loss, grad norm, each leaf's m and master move: 15c's
     gates), ms
     a step, host ms in the collectives and the allocator peak of each
     rank, and the f64 twin at GRID_F64_LAYERS layer (loss within 1e-10);
     (c) as (b) with the config's fsdp set (each layer's weights
     gathered over 'data' before use, their gradients reduce-scattered);
     (d) a checkpoint written on 2 x 2 restored on 1 x 2 (the cpu-small
     preset's width): the restored state has the saved bits;
     (e) the dry run's analytic records of every arch x shape on the
     reference's 16x16 and 2x16x16 meshes: none fails; a rank's train_4k
     bytes of dbrx, jamba and llama3.2-3b;
 17. serving in the reference's production layout on phase 14's world
     laid out (2, 2) (plain torch and collectives), llama3.2-3b at its
     published width: (a) prefill and SERVE_GRID_STEPS decode steps with
     the cache's positions over 'model' and with its kv heads over it,
     against the same calls in one process (logits a step, greedy
     tokens; SERVE_GRID_LAYERS layers in f32, SERVE_GRID_F64_LAYERS in
     f64), the collectives a step by kind and group, host ms in them, ms
     a step against one process; (b) the bf16 engine at all 28 layers
     (two slots a row) against the same grid's stepwise greedy oracle,
     each rank's parameter and cache bytes against ``decode_specs(...,
     grid=)``'s, prefill and decode ms beside the read bound, tok/s, each
     rank's peak;
 18. the encoder-decoder and the vlm in that layout on phase 14's world
     laid out (2, 2) (plain torch and collectives; counted, the "grid
     families" path, all zero), at their published widths, random
     weights from --seed: (a) a train step of seamless-m4t-large-v2
     (FAMILY_TRAIN_LAYERS + as many encoder layers, f32, fan-in) against
     one process at 15c's gates, its f64 twin's loss at 1e-10, ms a step,
     host ms in the collectives, each rank's peak; (b) seamless serving:
     4 prompts of 64 tokens on 128 encoder frames, prefill and 8 decode
     steps under both cache layouts against one process (f32 logits 1e-4
     of their norm and tokens equal, f64 1e-10), the collectives a step
     by kind and group, then bf16 at all 24 + 24 layers: ms a step beside
     the card's read bound, tok/s, finite logits, each rank's bytes
     against ``decode_specs(..., grid=)``'s; (c) llava-next-34b behind
     its 2880-patch prefix: the same serving gates (2 layers f32, 1 f64),
     a train step at 1 layer on the ranks laid out (1, 4) against one
     process, bf16 timing at LLAVA_BF16_LAYERS of 60 layers.
 19. the ssm family (mamba2-370m) in that layout on phase 14's world laid
     out (2, 2) (plain torch and collectives; counted, the "grid ssm"
     path, all zero), at its published width, random weights from
     --seed: (a) a train step at SSM_TRAIN_LAYERS of 48 layers in f32 on
     4 rows of two SSD chunks against one process (loss within 1e-6, the
     grad norm and m / master at 15c's gates, every master block moved),
     its f64 twin at 1 layer, ms a step, the share of it in the
     collectives, each rank's peak; (b) prefill and 8 decode steps of 4
     prompts of one SSD chunk in f32 (2 layers) and f64 (1 layer) against
     one process under both cache layouts, which give the same bits, the
     collectives a step by kind; (c) the bf16 engine at all 48 layers, two
     slots a row, against the grid's greedy oracle: ms a decode step,
     tok/s, the collectives of a decode call, each rank's bytes against
     ``decode_specs(..., grid=)``'s and the card's read bound.

Run from the repository root:  python3 chip_smoke.py [--iters N] [--seed N]
Needs one CUDA card; exits non-zero without one.  Prints a JSON line of
kernel measurements, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import core  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.subproblem import cholesky_nan  # noqa: E402
from repro_torch.core.tsqr import ridge_operand  # noqa: E402
from repro_torch.data import (PAPER_DATASETS, PAPER_DATASETS_FULL,  # noqa: E402
                              make_regression)
from repro_torch.kernels import gram as gk  # noqa: E402
from repro_torch.kernels.gram import _build  # noqa: E402
from repro_torch.kernels.gram.sampled_colmajor import (  # noqa: E402
    cols_packet_geometry)
from repro_torch.launch.bf16_packets import blocked_flat  # noqa: E402
from repro_torch.launch.tile_sweep import (apply_launcher,  # noqa: E402
                                           cols_apply_launcher,
                                           cols_packet_launcher,
                                           matvec_launcher)
from repro_torch.launch.timing import (KERNEL_NAMES, device_ms,  # noqa: E402
                                       event_ms, l2_flush, wall_ms)

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM3 bandwidth, the
# f32 / f64 rates of the CUDA cores outside the tensor cores, and the
# tensor cores' bf16 rate (the card's fastest way to take bf16 operands,
# whatever the kernel itself uses).
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"torch.float32": 67e12, "torch.float64": 34e12,
               "torch.bfloat16": 989e12}
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
TENANTS = 8                     # tenants of the batched engine's run
BATCHED_ITERS = 72              # 4 full outer steps at s = 16, a ragged 8
# Baselines against the direct solve: f32 at real-sim size (each side rounds
# its own O(d n) sums; the operator's condition is near 1 at this lambda),
# f64 at the 8x cut (CholeskyQR squares the operand's condition).
TOL_BASELINE_F32 = 1e-4
TOL_BASELINE_F64 = 1e-8
CG_MAX_ITERS = 100
HISTORY_ITERS = 20
# Phase 8: the fault matrix (kind, outer step, reason bit; the divergence
# and magnitude guards arm off one clean step, so the bit flip fires at 1),
# its solves' length, and the supervised restart's length and gates (w
# against the uninterrupted solve: the restart re-derives X^T w from the
# snapshot, which rounds apart from the recurrence's alpha).
FAULTS = (("nan_packet", 2, engine.GUARD_NONFINITE),
          ("bitflip", 1, engine.GUARD_MAGNITUDE),
          ("drop_shard", 2, engine.GUARD_SHARD_LOSS))
FAULT_ITERS = 256
SUPERVISED_ITERS = 512
TOL_SUPERVISED_F32 = 1e-5
TOL_SUPERVISED_F64 = 1e-10
# Phase 9: gloo ranks sharing the card, the solves' length (H = 256 outer
# steps at s = 1, 16 at s = 16), and the gate of a sharded solve against the
# local one (PERF.md section 2's f32 CA gate: P partial sums and one deferred
# update of s blocks round apart from the local solve's per-block updates).
# A batched packet and a single solve's are laid out differently, and gloo
# sums an element in an order set by its offset, so at four ranks a tenant
# and its single solve round apart: the gate is a few times the spread read
# on the H100 (6.77e-8 in each of four runs, PERF.md); at two ranks
# (one rounding either way) they are equal under torch.equal.
DIST_RANKS = 4
DIST_ITERS = 256
TOL_DIST_F32 = 1e-4
TOL_BATCHED_DIST_F32 = 5e-7
# Phase 10: the stated mean time between device losses for the snapshot
# cadence, in outer steps (1e5 outer steps of the primal at s = 16 are
# about 15 minutes of solving at phase 3's step time).
MTBF_OUTER = 1e5


_CARD: list = []


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (read
    once; raises without ``nvidia-smi``)."""
    if not _CARD:
        _CARD.append(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0])
    return _CARD[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def rel(a, b) -> float:
    """Relative Frobenius distance of a from b."""
    return float((a - b).double().norm() / b.double().norm().clamp_min(1e-300))


def cross_terms(G, flat):
    """G with the entries of equal indices (the diagonal and the duplicate
    pairs, all sums of squares) set to zero."""
    return G.masked_fill(flat[:, None] == flat[None, :], 0.0)


def ragged_flat(gen, n_total: int, m: int):
    """m indices, not a multiple of any tile, with one duplicate."""
    perm = torch.randperm(n_total, generator=gen, device=gen.device)[:m]
    perm[-1] = perm[0]
    return perm.to(torch.int32).contiguous()


def bound(kind: str, m: int, uniq: int, K: int, dtype,
          tenants: int = 1, indexed: bool = True) -> dict:
    """Least time for the function on these inputs: each input read once
    (only the sampled rows / columns of X, and the int32 indices where the
    kernel takes them), each output written once, against the operations at
    the CUDA-core rate of ``dtype``."""
    isz = 8 if str(dtype) == "torch.float64" else 4
    index_bytes = 4 * m if indexed else 0
    if kind == "packet":
        nbytes = (uniq * K + K + m * m + m) * isz + index_bytes
        flops = 2 * (m * (m + 1) // 2 * K + m * K)
    elif kind == "gram":                    # dense, no index, no residual
        nbytes = (m * K + m * m) * isz
        flops = 2 * (m * (m + 1) // 2 * K)
    elif kind == "matvec":
        nbytes = (uniq * K + tenants * K + tenants * m) * isz + index_bytes
        flops = 2 * tenants * m * K
    else:
        nbytes = (uniq * K + m + K) * isz + index_bytes
        flops = 2 * m * K
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[str(dtype)] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel_specs(d: int, n: int) -> list:
    """(kernel, info, plain, samples, contraction, kind, layout) of K1-K6."""
    return [
        (gk.gram_packet_sampled_rows, gk.ROWS_PACKET,
         gk.gram_packet_sampled_ref, d, n, "packet", "rows"),
        (gk.panel_apply_rows, gk.ROWS_APPLY, gk.panel_apply_ref, d, n,
         "apply", "rows"),
        (gk.gram_packet_sampled_cols, gk.COLS_PACKET,
         gk.gram_packet_sampled_cols_ref, n, d, "packet", "cols"),
        (gk.panel_apply_cols, gk.COLS_APPLY, gk.panel_apply_cols_ref, n, d,
         "apply", "cols"),
        (gk.panel_matvec_cols, gk.COLS_MATVEC, gk.panel_matvec_cols_ref, n, d,
         "matvec", "cols"),
        (gk.panel_matvec_rows, gk.ROWS_MATVEC, gk.panel_matvec_ref, d, n,
         "matvec", "rows"),
    ]


def check_matvec_identities(X, flat, vec, kern, layout: str, tag: str,
                            name: str) -> None:
    """The matvec kernel against the packet's r at scale = scale_r = 1 and
    its T-tenant launch against T single launches, under torch.equal."""
    packet = (gk.gram_packet_sampled_rows if layout == "rows"
              else gk.gram_packet_sampled_cols)
    u = vec[0].clone()
    _, r = packet(X, flat, u, scale=1.0, scale_r=1.0)
    same_r = torch.equal(kern(X, flat, u), r)
    out = kern(X, flat, vec)
    singles = all(torch.equal(out[j], kern(X, flat, vec[j]))
                  for j in range(vec.shape[0]))
    torch.cuda.synchronize()
    log(f"    {tag} {name} m={flat.shape[0]}: equal to the packet's r "
        f"{same_r}; {vec.shape[0]}-tenant launch equal to single launches "
        f"{singles}")
    if not (same_r and singles):
        raise AssertionError(f"{name}: matvec identities fail at "
                             f"m={flat.shape[0]} ({same_r}, {singles})")


def check_cols_packet_identity(X, flat, u, tag: str) -> None:
    """K3 on (X, flat) against K7 on the gathered transposed panel
    X[:, flat]^T at K3's chunk, with scale, reg and scale_r, under
    torch.equal: the two run the same tile over the same sums."""
    m, d = flat.shape[0], X.shape[0]
    knobs = {"scale": 0.5, "reg": 0.25, "scale_r": 2.0}
    G3, r3 = gk.gram_packet_sampled_cols(X, flat, u, **knobs)
    Y = X[:, flat.long()].T.contiguous()
    chunk = cols_packet_geometry(m, d, X.dtype).chunk
    G7, r7 = gk.gram_packet_dense(Y, u, bk=chunk, **knobs)
    same = torch.equal(G3, G7) and torch.equal(r3, r7)
    torch.cuda.synchronize()
    log(f"    {tag} gram_packet_sampled_cols m={m}: equal to K7 on "
        f"X[:, flat]^T at K3's chunk {chunk} {same}")
    if not same:
        raise AssertionError(f"K3 differs from K7 on its gathered panel at "
                             f"m={m}")


def check_kernels(X, gen, tag: str, ms: tuple, reps: int,
                  main_m: dict, tenants: int, flush=None,
                  kinds=("packet", "apply", "matvec"),
                  layouts=("rows", "cols")) -> dict:
    """Phase 2 on one X: every kernel of ``kinds`` and ``layouts`` against
    its plain version for each m in ``ms`` (the matvecs with ``tenants``
    vectors, and held to the packets' r); at the m's in ``main_m[kind]``
    also the timings, the matvecs' also with the L2 flushed by ``flush``
    before each call.
    Returns per-kernel records, the first timed m of each under the
    kernel's name."""
    d, n = X.shape
    tol = TOL_KERNEL[str(X.dtype)]
    out = {}
    for kern, info, plain, S, K, kind, layout in kernel_specs(d, n):
        if kind not in kinds or layout not in layouts:
            continue
        for m in ms:
            flat = (blocked_flat(gen, S, 8, m // 8) if m % 8 == 0
                    else ragged_flat(gen, S, m))
            shape = {"packet": (K,), "apply": (m,), "matvec": (tenants, K)}
            vec = torch.randn(shape[kind], generator=gen, device=X.device,
                              dtype=X.dtype)
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
            if kind == "matvec":
                check_matvec_identities(X, flat, vec, kern, layout, tag,
                                        info.name)
            if kind == "packet" and layout == "cols":
                check_cols_packet_identity(X, flat, vec, tag)
            timed = main_m.get(kind, ())
            if m not in timed:
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
            names = KERNEL_NAMES[kind if kind == "matvec"
                                 else f"{layout}_{kind}"]
            rec.update(time_kernel(X, flat, vec, kern, plain, kind, layout,
                                   names, reps))
            rec.update(bound(kind, m, uniq, K, X.dtype,
                             tenants if kind == "matvec" else 1))
            if kind == "packet":
                # K1's / K3's two passes apart (at both timed m, several
                # chunks)
                for key, part in (("tile_ms", "dense_tile"),
                                  ("reduce_ms", "dense_reduce")):
                    rec[key] = device_ms(lambda: kern(X, flat, vec), reps,
                                         (part,))
            if kind == "matvec":
                rec["tenants"] = tenants
                rec.update(time_cold(X, flat, vec, kind, layout, reps, flush))
                one = vec[0].clone()
                for key, val in (time_kernel(X, flat, one, kern, plain, kind,
                                             layout, names, reps)
                                 | time_cold(X, flat, one, kind, layout, reps,
                                             flush)).items():
                    rec[f"{key}_t1"] = val
                rec["bound_ms_t1"] = bound(kind, m, uniq, K, X.dtype)[
                    "bound_ms"]
            if layout == "cols":
                # scattered reads: one 32-byte sector per sampled element.  A
                # model of the traffic, not a measurement: it stays out of the
                # printed kernels line.
                rec["sector_ms"] = uniq * K * SECTOR / HBM_BYTES_PER_S * 1e3
                if kind != "matvec":                  # K3, K4 also L2 cold
                    rec.update(time_cold(X, flat, vec, kind, layout, reps,
                                         flush))
            log(f"    device {rec['ms']:.4f} ms (wrapper incl. host checks "
                f"{rec['wrapper_ms']:.4f}), plain {rec['plain_ms']:.4f}, "
                f"library {rec['library_ms']:.4f} (gather "
                f"{rec['gather_ms']:.4f}, gather + library "
                f"{rec['gather_ms'] + rec['library_ms']:.4f}), bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})"
                + (f", sector bound {rec['sector_ms']:.4f} ms"
                   if "sector_ms" in rec else "")
                + (f"; dense_tile {rec['tile_ms']:.4f}, dense_reduce "
                   f"{rec['reduce_ms']:.4f}" if "tile_ms" in rec else "")
                + (f"; {tenants} tenants. One tenant: device "
                   f"{rec['ms_t1']:.4f}, wrapper {rec['wrapper_ms_t1']:.4f}, "
                   f"plain {rec['plain_ms_t1']:.4f}, library (torch.mv) "
                   f"{rec['library_ms_t1']:.4f} (gather + library "
                   f"{rec['gather_ms_t1'] + rec['library_ms_t1']:.4f}), bound "
                   f"{rec['bound_ms_t1']:.4f}" if kind == "matvec" else ""))
            if "ms_cold" in rec:
                log_cold(rec, "")
            if kind == "matvec":
                log_cold(rec, "_t1")
            key = info.name if m == timed[0] else f"{info.name}@m{m}"
            out[key] = rec
    return out


def check_dense_kernels(X, gen, tag: str, ms: tuple, reps: int,
                        timed_m: int | None) -> dict:
    """Phase 2 for K7 / K8 on a panel Y = X[flat] gathered beforehand (the
    reference's kernels_bench compares the two the same way): each against
    its plain version, K7 equal to K1 on (X, flat) and K8 equal to K7's G
    (torch.equal); at ``timed_m`` K7's timings.  Returns K7's record."""
    tol = TOL_KERNEL[str(X.dtype)]
    d, n = X.shape
    out = {}
    for m in ms:
        flat = (blocked_flat(gen, d, 8, m // 8) if m % 8 == 0
                else ragged_flat(gen, d, m))
        Y = X[flat.long()].contiguous()
        u = torch.randn((n,), generator=gen, device=X.device, dtype=X.dtype)
        got7 = gk.gram_packet_dense(Y, u)
        got8 = gk.gram_dense(Y)
        want7 = gk.gram_packet_ref(Y, u)
        want8 = gk.gram_ref(Y)
        torch.cuda.synchronize()
        errs = [rel(got7[0], want7[0]), rel(got7[1], want7[1]),
                rel(cross_terms(got7[0], flat), cross_terms(want7[0], flat)),
                rel(got8, want8),
                rel(cross_terms(got8, flat), cross_terms(want8, flat))]
        max_abs = max(float((g - w).abs().max())
                      for g, w in ((got7[0], want7[0]), (got7[1], want7[1]),
                                   (got8, want8)))
        G1, r1 = gk.gram_packet_sampled_rows(X, flat, u)
        same_k1 = torch.equal(got7[0], G1) and torch.equal(got7[1], r1)
        same_k7 = torch.equal(got8, got7[0])
        sym = torch.equal(got7[0], got7[0].T) and torch.equal(got8, got8.T)
        log(f"  {tag} gram_packet_dense / gram_dense m={m:4d} K={n}: rel err "
            f"G, r, G cross terms, K8 G, K8 cross terms "
            + " ".join(f"{e:.2e}" for e in errs)
            + f" (tol {tol:.0e}), max abs {max_abs:.2e}; K7 == K1 {same_k1}, "
            f"K8 == K7's G {same_k7}, symmetric {sym}")
        if not all(math.isfinite(e) and e <= tol for e in errs):
            raise AssertionError(f"K7 / K8 disagree with their plain versions "
                                 f"at m={m}: {errs}")
        if not (same_k1 and same_k7 and sym):
            raise AssertionError(f"K7 / K8 identities fail at m={m}: "
                                 f"{same_k1}, {same_k7}, {sym}")
        if m != timed_m:
            continue
        info = gk.DENSE_PACKET
        rec = {"name": info.name, "route": "cuda", "source": info.source,
               "replaces": info.replaces, "max_abs_err": max_abs, "m": m,
               "K": n, "dtype": str(X.dtype).replace("torch.", ""),
               "ms": device_ms(lambda: gk.gram_packet_dense(Y, u), reps,
                               KERNEL_NAMES["dense"]),
               "wrapper_ms": wall_ms(lambda: gk.gram_packet_dense(Y, u), reps),
               "plain_ms": device_ms(lambda: gk.gram_packet_ref(Y, u), reps)}
        rhs = torch.cat([Y.T, u[:, None]], dim=1).contiguous()
        rec["library_ms"] = device_ms(lambda: torch.mm(Y, rhs), reps)
        rec.update(bound("packet", m, m, n, X.dtype, indexed=False))
        # the two kernels of K7 apart
        rec["tile_ms"] = device_ms(lambda: gk.gram_packet_dense(Y, u), reps,
                                   ("dense_tile",))
        rec["reduce_ms"] = device_ms(lambda: gk.gram_packet_dense(Y, u),
                                     reps, ("dense_reduce",))
        log(f"    device {rec['ms']:.4f} ms (wrapper {rec['wrapper_ms']:.4f};"
            f" dense_tile {rec['tile_ms']:.4f}, dense_reduce "
            f"{rec['reduce_ms']:.4f}), plain "
            f"{rec['plain_ms']:.4f}, library (mm on [Y^T | u]) "
            f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']})")
        out[info.name] = rec
    return out


# bf16 packets (K1, K3, K7 on the tensor cores, f32 sums and outputs):
# within the reference's bf16 tolerance (tests/test_kernels.py, 2e-2) of the
# bf16 plain version, and within 1e-4 of the plain version in f64 on the
# upcast operand (G, r and G's cross terms); the f32 kernel on the upcast
# operand is logged beside, no longer equal (mma sums its slices in its own
# order).  K1 == K7 on X[flat], K3 == K7 on X[:, flat]^T at K3's chunk, G ==
# G^T and two runs' bits under torch.equal.
TOL_BF16 = 2e-2
TOL_BF16_F64 = 1e-4


def bf16_bound(m: int, uniq: int, K: int, indexed: bool) -> dict:
    """The packet's bound with bf16 inputs (2 bytes: the sampled rows and u)
    and f32 outputs (4 bytes: G and r), against the operations at the
    card's bf16 tensor-core rate."""
    nbytes = 2 * (uniq * K + K) + 4 * (m * m + m) + (4 * m if indexed else 0)
    flops = 2 * (m * (m + 1) // 2 * K + m * K)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S["torch.bfloat16"] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def parent_bf16_times(parent: str, seed: int, reps: int) -> dict:
    """The bf16 packets of the tree at ``parent`` (a checkout of another
    commit, with its own kernels built on first use), timed by
    launch/bf16_packets.py on the inputs phase 2c draws: {kernel: {m: ms}}.
    Run in a process of its own before this process's first profiler trace
    and after its last: a trace taken here after another process has
    traced the card loses device events (seen on the H100)."""
    script = (Path(__file__).resolve().parent / "src/repro_torch/launch"
              / "bf16_packets.py")
    env = dict(os.environ, PYTHONPATH=str(Path(parent).resolve() / "src"))
    out = subprocess.run([sys.executable, str(script), "--seed", str(seed),
                          "--reps", str(reps)], env=env, capture_output=True,
                         text=True, check=True).stdout
    return {k: {int(m): v for m, v in t.items()}
            for k, t in json.loads(out.strip().splitlines()[-1]).items()}


def bf16_gates(tag: str, got, want16, want64, f32, flat) -> float:
    """Phase 2c's gates on one bf16 packet: G and r against the bf16 plain
    version (TOL_BF16) and the f64 one on the upcast operand (TOL_BF16_F64,
    G's cross terms too), G == G^T; logged beside the f32 kernel on the
    upcast operand.  Returns the largest absolute error against f64."""
    G, r = got
    errs16 = [rel(G, want16[0]), rel(r, want16[1]),
              rel(cross_terms(G, flat), cross_terms(want16[0], flat))]
    errs64 = [rel(G, want64[0]), rel(r, want64[1]),
              rel(cross_terms(G, flat), cross_terms(want64[0], flat))]
    max_abs = max(float((a.double() - b).abs().max())
                  for a, b in ((G, want64[0]), (r, want64[1])))
    sym = torch.equal(G, G.T)
    eq32 = torch.equal(G, f32[0]) and torch.equal(r, f32[1])
    log(f"  {tag}: rel err G, r, G cross terms against the bf16 plain "
        "version " + " ".join(f"{e:.2e}" for e in errs16)
        + f" (tol {TOL_BF16:.0e}), against f64 on the upcast operand "
        + " ".join(f"{e:.2e}" for e in errs64)
        + f" (tol {TOL_BF16_F64:.0e}), max abs {max_abs:.2e}; G == G^T "
        f"{sym}; the f32 kernel on the upcast operand: equal {eq32}, rel "
        f"G {rel(G, f32[0]):.2e}, r {rel(r, f32[1]):.2e}")
    if G.dtype != torch.float32 or not (
            all(math.isfinite(e) and e <= TOL_BF16 for e in errs16)
            and all(math.isfinite(e) and e <= TOL_BF16_F64 for e in errs64)):
        raise AssertionError(f"{tag} disagrees with its plain versions: "
                             f"{errs16}, {errs64}")
    if not sym:
        raise AssertionError(f"{tag}: G is not symmetric")
    return max_abs


BF16_KEYS = (("rows", gk.ROWS_PACKET_BF16), ("dense", gk.DENSE_PACKET_BF16),
             ("cols", gk.COLS_PACKET_BF16))


def bf16_record_key(info, m: int) -> str:
    return info.name if m == 128 else f"{info.name}@m{m}"


def log_parent_turns(records: dict, before: dict | None,
                     after: dict | None) -> None:
    """Phase 2c's times beside the parent commit's design, taken in turns
    (the parent at the run's start and end, this design twice in 2c)."""
    if before is None:
        log("  2c the parent design's times: not measured in this run "
            "(--parent DIR times them in turns with these)")
        return
    for m in (128, 8):
        for key, info in BF16_KEYS:
            rec = records[bf16_record_key(info, m)]
            rec["parent_ms"] = [before[key][m], after[key][m]]
            log(f"  2c {info.name} m={m}: parent design {before[key][m]:.4f}"
                f", this design {rec['ms']:.4f}, {rec['again_ms']:.4f}, "
                f"parent design {after[key][m]:.4f} ms (in turns)")


def check_bf16_packets(X, seed: int, reps: int, twice: bool
                       ) -> tuple[dict, dict]:
    """Phase 2c: K1, K3 and K7 on the real-sim X cast to bf16 at m = 128
    and 8 (inputs from launch/bf16_packets.py): the gates of bf16_gates, K1
    == K7 on X[flat], K3 == K7 on X[:, flat]^T at K3's chunk and two runs
    equal (torch.equal); timed beside their bound, the plain version (CUDA
    events), the f32 kernel on the upcast operand and a library call (a
    bf16 product on the tensor cores, f32 sums, on the gathered panel);
    with ``twice`` the three kernels again (``again_ms``, main's turns
    against a parent commit's design).
    Then the counted path: one packet of each through the public entry
    points at each m.  Returns (records, the path's launch counts)."""
    from repro_torch.launch import bf16_packets as bp
    d, n = X.shape
    Xb = X.to(torch.bfloat16)
    Xup = Xb.float()
    cases = bp.cases(Xb, seed)
    recs = {}
    for case in cases:
        m, flat, u, flat_c, u_c = (case[k] for k in ("m", "flat", "u",
                                                     "flat_c", "u_c"))
        Yb = Xb[flat.long()].contiguous()
        G1, r1 = gk.gram_packet_sampled_rows(Xb, flat, u)
        G7, r7 = gk.gram_packet_dense(Yb, u)
        again = gk.gram_packet_sampled_rows(Xb, flat, u)
        torch.cuda.synchronize()
        max_abs = bf16_gates(
            f"bf16 K1 m={m:4d}", (G1, r1), gk.gram_packet_ref(Yb, u),
            gk.gram_packet_ref(Yb.double(), u.double()),
            gk.gram_packet_sampled_rows(Xup, flat, u.float()), flat)
        eq_k7 = torch.equal(G1, G7) and torch.equal(r1, r7)
        rerun = torch.equal(again[0], G1) and torch.equal(again[1], r1)
        log(f"    K1 == K7 on X[flat] {eq_k7}; two runs equal {rerun}")
        if not (eq_k7 and rerun):
            raise AssertionError(f"bf16 K1 / K7 identities fail at m={m}: "
                                 f"{eq_k7}, {rerun}")
        Yc = Xb[:, flat_c.long()].T.contiguous()
        chunk = cols_packet_geometry(m, d, torch.bfloat16).chunk
        G3, r3 = gk.gram_packet_sampled_cols(Xb, flat_c, u_c)
        G7c, r7c = gk.gram_packet_dense(Yc, u_c, bk=chunk)
        again = gk.gram_packet_sampled_cols(Xb, flat_c, u_c)
        torch.cuda.synchronize()
        max_abs3 = bf16_gates(
            f"bf16 K3 m={m:4d}", (G3, r3), gk.gram_packet_ref(Yc, u_c),
            gk.gram_packet_ref(Yc.double(), u_c.double()),
            gk.gram_packet_sampled_cols(Xup, flat_c, u_c.float()), flat_c)
        eq_k7c = torch.equal(G3, G7c) and torch.equal(r3, r7c)
        rerun = torch.equal(again[0], G3) and torch.equal(again[1], r3)
        log(f"    K3 == K7 on X[:, flat]^T at K3's chunk {chunk} {eq_k7c}; "
            f"two runs equal {rerun}")
        if not (eq_k7c and rerun):
            raise AssertionError(f"bf16 K3 / K7 identities fail at m={m}: "
                                 f"{eq_k7c}, {rerun}")
        calls = bp.calls(Xb, case)
        for key, info, plain, f32, Y, uu, fl, K, indexed in (
                ("rows", gk.ROWS_PACKET_BF16,
                 lambda: gk.gram_packet_sampled_ref(Xb, flat, u),
                 lambda: gk.gram_packet_sampled_rows(Xup, flat, u.float()),
                 Yb, u, flat, n, True),
                ("dense", gk.DENSE_PACKET_BF16,
                 lambda: gk.gram_packet_ref(Yb, u),
                 lambda: gk.gram_packet_dense(Yb.float(), u.float()),
                 Yb, u, flat, n, False),
                ("cols", gk.COLS_PACKET_BF16,
                 lambda: gk.gram_packet_sampled_cols_ref(Xb, flat_c, u_c),
                 lambda: gk.gram_packet_sampled_cols(Xup, flat_c,
                                                     u_c.float()),
                 Yc, u_c, flat_c, d, True)):
            rhs = torch.cat([Y.T, uu[:, None]], dim=1).contiguous()
            rec = {"name": info.name, "route": "cuda",
                   "source": info.source, "replaces": info.replaces,
                   "max_abs_err": max_abs3 if key == "cols" else max_abs,
                   "m": m, "K": K, "dtype": "bfloat16",
                   "ms": device_ms(calls[key], reps, bp.NAMES),
                   # CUDA events: the bf16 plain version (a gather, casts
                   # and cuBLAS's f32 products) does not launch the same
                   # kernels on every call, which a profiler count needs
                   "plain_ms": event_ms(plain, reps),
                   "library_ms": device_ms(lambda: torch.mm(Y, rhs), reps),
                   "f32_ms": device_ms(f32, reps, bp.NAMES)}
            uniq = int(torch.unique(fl).numel()) if indexed else m
            rec.update(bf16_bound(m, uniq, K, indexed))
            extra = ""
            if indexed:         # K1 / K3 start from X: PyTorch's gather first
                rec["gather_ms"] = device_ms(
                    gather_call(Xb, fl, "rows" if key == "rows" else "cols"),
                    reps)
                extra = (f" (gather {rec['gather_ms']:.4f}, gather + library"
                         f" {rec['gather_ms'] + rec['library_ms']:.4f})")
            if key == "cols":
                rec["sector_ms"] = uniq * d * SECTOR / HBM_BYTES_PER_S * 1e3
                extra += (f"; sector traffic of the scattered columns (one "
                          f"32-byte sector an element) "
                          f"{rec['sector_ms']:.4f} ms")
            log(f"    {info.name} m={m}: device {rec['ms']:.4f} ms (f32 "
                f"kernel on the upcast operand {rec['f32_ms']:.4f}), plain "
                f"{rec['plain_ms']:.4f}, library (bf16 mm on [Y^T | u]) "
                f"{rec['library_ms']:.4f}{extra}, bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; device / "
                f"bound {rec['ms'] / rec['bound_ms']:.1f}, device / library "
                f"{rec['ms'] / rec['library_ms']:.2f})")
            recs[bf16_record_key(info, m)] = rec
    if twice:
        now = bp.times(Xb, cases, reps)
        for case in cases:
            for key, info in BF16_KEYS:
                recs[bf16_record_key(info, case["m"])]["again_ms"] = \
                    now[key][case["m"]]
    # the counted path: the packets through the public entry points
    gk.reset_launch_counts()
    for case in cases:
        flat, u = case["flat"], case["u"]
        gk.gram_packet_sampled(Xb, flat, u)
        gk.gram_packet(Xb[flat.long()].contiguous(), u)
        gk.gram_packet_sampled(gk.ColMajorOperand(Xb), case["flat_c"],
                               case["u_c"])
    torch.cuda.synchronize()
    counts = launches()
    log(f"  bf16 packets path: launches {counts}")
    del Xb, Xup
    return recs, counts


def check_cg_shape(X, gen, reps: int, flush) -> dict:
    """Phase 2 for K2 and K6 at the shape CG gives them: flat = arange(d),
    m = d, one vector; against their plain versions, timed, also with the
    L2 flushed before each call."""
    tol = TOL_KERNEL[str(X.dtype)]
    d, n = X.shape
    flat = torch.arange(d, dtype=torch.int32, device=X.device)
    out = {}
    for kern, info, plain, kind, vec_len, names in (
            (gk.panel_apply_rows, gk.ROWS_APPLY, gk.panel_apply_ref, "apply",
             d, KERNEL_NAMES["rows_apply"]),
            (gk.panel_matvec_rows, gk.ROWS_MATVEC, gk.panel_matvec_ref,
             "matvec", n, KERNEL_NAMES["matvec"])):
        vec = torch.randn((vec_len,), generator=gen, device=X.device,
                          dtype=X.dtype)
        got, want = kern(X, flat, vec), plain(X, flat, vec)
        torch.cuda.synchronize()
        err = rel(got, want)
        rec = {"name": info.name, "m": d, "K": n, "rel_err": err,
               "max_abs_err": float((got - want).abs().max())}
        del got, want
        log(f"  f32 {info.name} at CG's shape m = d = {d}, K = {n}, T = 1: "
            f"rel err {err:.2e} (tol {tol:.0e})")
        if not (math.isfinite(err) and err <= tol):
            raise AssertionError(f"{info.name} disagrees with its plain "
                                 f"version at CG's shape: {err}")
        rec.update(time_kernel(X, flat, vec, kern, plain, kind, "rows", names,
                               reps))
        rec.update(bound(kind, d, d, n, X.dtype))
        log(f"    device {rec['ms']:.4f} ms (wrapper incl. host checks "
            f"{rec['wrapper_ms']:.4f}), plain {rec['plain_ms']:.4f}, library "
            f"{rec['library_ms']:.4f} (gather {rec['gather_ms']:.4f}, gather "
            f"+ library {rec['gather_ms'] + rec['library_ms']:.4f}), bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        rec.update(time_cold(X, flat, vec, kind, "rows", reps, flush))
        log_cold(rec, "")
        if kind == "apply":
            # cuBLAS's gemv on X in place (X^T v, the access pattern of K2
            # and of CG's dense route), beside the library call on the
            # transposed copy: log and --json only
            rec["library_inplace_ms"] = device_ms(lambda: torch.mv(X.T, vec),
                                                  reps)
            rec["library_inplace_ms_cold"] = event_ms(
                lambda: torch.mv(X.T, vec), reps, flush)
            log(f"    torch.mv(X.T, v) on X in place: warm "
                f"{rec['library_inplace_ms']:.4f} ms, cold "
                f"{rec['library_inplace_ms_cold']:.4f}")
        out[f"{info.name}@cg"] = rec
    return out


def time_kernel(X, flat, vec, kern, plain, kind: str, layout: str,
                names: tuple, reps: int) -> dict:
    """Warm device times of the kernel, its plain version, its library call
    and PyTorch's gather of the sampled panel that the library call starts
    from (not part of ``library_ms``), and the wrapper's time per call."""
    return {"ms": device_ms(lambda: kern(X, flat, vec), reps, names),
            "wrapper_ms": wall_ms(lambda: kern(X, flat, vec), reps),
            "plain_ms": device_ms(lambda: plain(X, flat, vec), reps),
            "library_ms": device_ms(library_call(X, flat, vec, kind, layout),
                                    reps),
            "gather_ms": device_ms(gather_call(X, flat, layout), reps)}


def gather_call(X, flat, layout: str):
    """PyTorch's gather of the sampled rows (``layout`` "rows") or columns
    of X: one library kernel, the same reads of X as the kernels'."""
    dim, fl = (0 if layout == "rows" else 1), flat.long()
    return lambda: X.index_select(dim, fl)


def time_cold(X, flat, vec, kind: str, layout: str, reps: int,
              flush) -> dict:
    """A matvec, an apply or the column packet (launched as its wrapper
    launches it, less the operand checks that wait on the device), its
    library call and PyTorch's gather of the same sampled rows / columns,
    with the L2 cache flushed before each call."""
    launchers = {("apply", "rows"): apply_launcher,
                 ("apply", "cols"): cols_apply_launcher,
                 ("packet", "cols"): cols_packet_launcher}
    launch = (launchers[kind, layout](X, flat, vec) if kind != "matvec"
              else matvec_launcher(X, flat, vec, layout))
    return {"ms_cold": event_ms(launch, reps, flush),
            "library_ms_cold": event_ms(library_call(X, flat, vec, kind,
                                                     layout), reps, flush),
            "gather_ms_cold": event_ms(gather_call(X, flat, layout), reps,
                                       flush)}


def log_cold(rec: dict, suffix: str) -> None:
    """The L2-cold times of a record beside its bound (and, for the column
    layout, the sector traffic)."""
    cold, lib = rec[f"ms_cold{suffix}"], rec[f"library_ms_cold{suffix}"]
    b = rec[f"bound_ms{suffix}"]
    log(f"    L2 cold{' (one tenant)' if suffix else ''}: device {cold:.4f} "
        f"ms, library {lib:.4f}; device / bound {cold / b:.2f}; PyTorch's "
        f"gather of the same elements (index_select) warm "
        f"{rec[f'gather_ms{suffix}']:.4f}, cold "
        f"{rec[f'gather_ms_cold{suffix}']:.4f}"
        + (f", device / sector bound {cold / rec['sector_ms']:.2f}"
           if "sector_ms" in rec else ""))


def tf32_cross_err(X, flat, vec, plain, G) -> float:
    """The cross-term error of the plain packet with its products rounded to
    TF32, against the f32 ``G``: what the f32 gate has to be able to see."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        G_tf32 = plain(X, flat, vec)[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return rel(cross_terms(G_tf32, flat), cross_terms(G, flat))


def library_call(X, flat, vec, kind: str, layout: str):
    """One cuBLAS call computing the kernel's function from the sampled panel
    gathered beforehand (the gather is not part of the call): [G | r] as one
    matrix product, the apply as one matrix-vector product, the matvec as
    ``torch.mv`` for one vector and as one matrix product for T tenant
    vectors."""
    fl = flat.long()
    if layout == "rows":
        Y = X.index_select(0, fl)                     # (m, n)
    else:
        Y = X.index_select(1, fl).T.contiguous()      # (m, d)
    if kind == "packet":
        rhs = torch.cat([Y.T, vec[:, None]], dim=1).contiguous()
        return lambda: torch.mm(Y, rhs)
    if kind == "matvec":
        if vec.dim() == 1:
            return lambda: torch.mv(Y, vec)
        tT = vec.T.contiguous()
        return lambda: torch.mm(Y, tT)
    Yt = Y.T.contiguous()
    return lambda: torch.mv(Yt, vec)


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
            before = launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = solve(X, y, lam, b, s, iters, idx=idx)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = ran_since(before)
            outer = -(-iters // s)
            packet, apply = (("gram_packet_sampled_rows", "panel_apply_rows")
                             if form == "primal" else
                             ("gram_packet_sampled_cols", "panel_apply_cols"))
            want = dict.fromkeys(launches(), 0)
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
    counts = launches()   # main path ends here

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
        before = launches()
        t0 = time.perf_counter()
        ref = solve(X, y, lam, b, 16, iters, idx=idx, impl="ref")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if launches() != before:
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
    b = idx_p.shape[1]
    for form, solve, idx in (("primal", core.ca_bcd, idx_p[:iters]),
                             ("dual", core.ca_bdcd, idx_d[:iters])):
        for s in (1, 16):
            stats[f"profile_{form}_s{s}"] = profile_run(
                lambda: solve(X, y, lam, b, s, iters, idx=idx),
                f"{form:6s} s={s:2d}, {iters} iters", 6)


def profile_run(fn, tag: str, top_n: int) -> dict:
    """Wall time of ``fn`` run unprofiled against the device's busy time in a
    profiler trace of a second run, the kernels that take it, and the host
    operations with the most self CPU time (under the profiler, which adds
    its own cost to each)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_name, count = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name] = (per_name.get(e.name, 0.0)
                                + e.time_range.elapsed_us() / 1e3)
            count[e.name] = count.get(e.name, 0) + 1
    busy = sum(per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:top_n]
    log(f"  {tag}: wall {wall:.1f} ms, device busy {busy:.1f} ms, idle "
        f"{1 - busy / wall:.1%}")
    for name, ms in top:
        log(f"      {ms:9.3f} ms  {name[:90]}")
    # the port's own kernels in the trace, each with its launches
    ours = {name: [ms, count[name]] for name, ms in per_name.items()
            if any(k in name for names in KERNEL_NAMES.values()
                   for k in names)}
    log("    the port's kernels (ms, launches, ms a launch):")
    for name, (ms, n) in sorted(ours.items(), key=lambda kv: -kv[1][0]):
        log(f"      {ms:9.3f} ms  {n:6d}  {ms / n:.4f}  {name[:70]}")
    host = sorted(((a.key, a.self_cpu_time_total / 1e3, a.count)
                   for a in prof.key_averages()), key=lambda r: -r[1])[:top_n]
    log("    host, self CPU time under the profiler:")
    for name, ms, count in host:
        log(f"      {ms:9.3f} ms  {count:6d} calls  {name[:70]}")
    return {"wall_ms": wall, "busy_ms": busy, "idle": 1 - busy / wall,
            "top": [[name[:120], ms] for name, ms in top],
            "kernels": {name[:160]: v for name, v in ours.items()},
            "host_top": [[name[:120], ms, count] for name, ms, count in host]}


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


def tenant_problem(X, y, lam, gen, T: int) -> tuple:
    """T tenant targets around y, mixed l2 weights around ``lam`` and, for
    the proximal, l1 weights that are fractions of the lasso critical value
    max |X y| / n (all > 0)."""
    n = y.shape[0]
    noise = torch.randn((T, n), generator=gen, device=y.device,
                        dtype=y.dtype)
    ys = y[None, :] + 0.1 * float(y.std()) * noise
    lams = [lam * 2.0 ** (t % 8 - 2) for t in range(T)]
    lam1_max = float((X @ y).abs().max()) / n
    lam1s = [lam1_max * (0.005 + 0.01 * (t % 8)) for t in range(T)]
    return ys, lams, lam1s


def batched_engine(X, y, lam, gen, iters: int, stats: dict) -> dict:
    """Phase 5: the tenant-batched engine at real-sim size, counted; every
    tenant against its single solve through the kernels under torch.equal;
    time per outer step at T in {1, 8, 32}; the device-idle share."""
    d, n = X.shape
    b, s, T = 8, 16, 8
    plan = core.SolverPlan(b=b, s=s)
    ys, lams, lam1s = tenant_problem(X, y, lam, gen, 32)
    forms = {"primal": d, "dual": n, "proximal": d}
    idx = {f: core.sample_blocks(gen, dim, b, iters)
           for f, dim in forms.items()}

    def batch(form, t):
        coeffs = {"lam1": lam1s[:t]} if form == "proximal" else {}
        return core.TenantBatch(ys=ys[:t], lams=lams[:t], coeffs=coeffs)

    outer = -(-iters // s)
    results = {}
    gk.reset_launch_counts()                          # batched path starts
    for form in forms:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[form] = core.s_step_solve_batched(form, plan, X,
                                                  batch(form, T), iters,
                                                  idx=idx[form])
        torch.cuda.synchronize()
        log(f"  {form:8s} T={T}: batched solve {time.perf_counter() - t0:.3f}"
            f" s ({iters} iterations, {outer} outer steps)")
    counts = launches()  # batched path ends
    want = dict.fromkeys(launches(), 0)
    want.update({"gram_packet_sampled_rows": 2 * outer,
                 "panel_apply_rows": 2 * T * iters,
                 "gram_packet_sampled_cols": outer,
                 "panel_apply_cols": T * iters,
                 "panel_matvec_cols": outer, "panel_matvec_rows": 2 * outer})
    log(f"  launches {counts}")
    if counts != want:
        raise AssertionError(f"batched launches {counts}, expected {want}")

    for form, res in results.items():
        worst = 0.0
        for t in range(T):
            f = (core.ProximalElasticNet(lam1=lam1s[t]) if form == "proximal"
                 else form)
            single = core.s_step_solve(f, plan, X, ys[t], lams[t], iters,
                                       idx=idx[form])
            if not (torch.equal(res.ws[t], single.w)
                    and torch.equal(res.alphas[t], single.alpha)):
                raise AssertionError(f"{form}: tenant {t} of the batched "
                                     "solve differs from its single solve")
            if not bool(torch.isfinite(single.w).all()):
                raise AssertionError(f"{form}: tenant {t} is not finite")
            worst = max(worst, float(single.history["residual"][-1]))
        nnz = ""
        if form == "proximal":
            nnz = ", nonzeros " + " ".join(
                str(int((res.ws[t] != 0).sum())) for t in range(T))
        log(f"  {form:8s}: all {T} tenants equal their single solves "
            f"(torch.equal on w and alpha); largest final residual "
            f"{worst:.4e}{nnz}")

    # Host-bound times move from run to run: three rounds over T, median
    # and range reported.
    walls = {t: [] for t in (1, 8, 32)}
    for _ in range(3):
        for t in walls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            core.s_step_solve_batched("primal", plan, X, batch("primal", t),
                                      iters, idx=idx["primal"])
            torch.cuda.synchronize()
            walls[t].append(time.perf_counter() - t0)
    for t, ws in walls.items():
        wall = sorted(ws)[1]
        stats[f"batched_primal_T{t}"] = {
            "wall_s": ws, "ms_per_outer": wall / outer * 1e3,
            "tenant_it_per_s": t * iters / wall}
        log(f"  primal T={t:2d}: {wall / outer * 1e3:.2f} ms per outer step "
            f"(median of 3; {min(ws) / outer * 1e3:.2f} to "
            f"{max(ws) / outer * 1e3:.2f}), {t * iters / wall:.1f} tenant "
            f"inner it/s")

    stats["profile_batched_primal_T8"] = profile_run(
        lambda: core.s_step_solve_batched("primal", plan, X,
                                          batch("primal", T), iters,
                                          idx=idx["primal"]),
        f"profile, primal T={T}, {iters} iters", 10)
    return counts


def service_run(X, y, lam, gen, stats: dict) -> dict:
    """Phase 6: the solve service at real-sim size, primal then dual, 24
    requests through 16 slots (counted); every ticket replayed as a single
    solve over the index chunks of its own steps, under torch.equal."""
    from repro_torch.serve import SolverService, SolverServiceConfig
    from repro_torch.serve import solver_service as svc_mod
    cfg = SolverServiceConfig(slots=16, min_bucket=8, chunk_iters=32,
                              max_iters=128, seed=1)
    plan = core.SolverPlan(b=8, s=16)
    requests = 24
    ys, lams, _ = tenant_problem(X, y, lam, gen, requests)
    draw = svc_mod.sample_blocks
    chunks = []

    def recording(generator, n_total, b, iters):
        idx = draw(generator, n_total, b, iters)
        chunks.append(idx)
        return idx

    runs = []
    svc_mod.sample_blocks = recording
    try:
        gk.reset_launch_counts()                      # service path starts
        for form in ("primal", "dual"):
            chunks.clear()
            svc = SolverService(X, plan, form, cfg)
            rids = [svc.submit(ys[i], lams[i]) for i in range(requests)]
            first = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while svc.table.pending or svc.table.any_active:
                svc.step()
                for rid in rids:
                    if svc.table.requests[rid].slot >= 0:
                        first.setdefault(rid, len(chunks) - 1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tickets = [svc.result(rid) for rid in rids]
            its = sum(t.iters for t in tickets)
            stats[f"service_{form}"] = {
                "wall_s": wall, "steps": len(chunks),
                "solves_per_s": requests / wall,
                "tenant_it_per_s": its / wall}
            log(f"  {form:6s}: {requests} requests, {len(chunks)} steps, "
                f"{wall:.3f} s: {requests / wall:.2f} solves/s, "
                f"{its / wall:.1f} tenant inner it/s")
            runs.append((form, rids, first, tickets, list(chunks)))
        counts = launches()  # path ends
    finally:
        svc_mod.sample_blocks = draw
    log(f"  launches {counts}")

    for form, rids, first, tickets, drawn in runs:
        for i, (rid, ticket) in enumerate(zip(rids, tickets)):
            k0, steps = first[rid], ticket.iters // cfg.chunk_iters
            idx = torch.cat(drawn[k0:k0 + steps])
            single = core.s_step_solve(form, plan, X, ys[i], lams[i],
                                       ticket.iters, idx=idx)
            w = torch.from_numpy(ticket.w).to(X.device)
            alpha = torch.from_numpy(ticket.alpha).to(X.device)
            if not (torch.equal(w, single.w)
                    and torch.equal(alpha, single.alpha)):
                raise AssertionError(f"{form}: ticket {rid} differs from its "
                                     "replayed single solve")
            if not (math.isfinite(ticket.residual) and ticket.iters == 128):
                raise AssertionError(f"{form}: ticket {rid}: {ticket}")
        log(f"  {form:6s}: all {requests} tickets equal their replayed "
            f"single solves (torch.equal on w and alpha)")
    return counts


def k8_full_shape(X, lam: float, reps: int) -> dict:
    """Phase 7, not counted: K8 on CholeskyQR's real-sim operand A^T
    (d, n + d) against its plain version and against an f64 product of the
    same f32 operand, whose entries' products are exact in f64; then its
    timings.  Returns K8's record."""
    info = gk.DENSE_GRAM
    tol = TOL_KERNEL[str(X.dtype)]
    At = ridge_operand(X, lam)
    m, K = At.shape
    G, Gp = gk.gram_dense(At), gk.gram_ref(At)
    A64 = At.double()
    G64 = A64 @ A64.T
    del A64
    torch.cuda.synchronize()
    eye = torch.arange(m, device=X.device)
    errs = {"kernel_vs_plain": rel(G, Gp), "kernel_vs_f64": rel(G, G64),
            "plain_vs_f64": rel(Gp, G64),
            "cross_kernel_vs_plain": rel(cross_terms(G, eye),
                                         cross_terms(Gp, eye)),
            "cross_kernel_vs_f64": rel(cross_terms(G, eye),
                                       cross_terms(G64, eye))}
    max_abs = float((G - Gp).abs().max())
    sym = torch.equal(G, G.T)
    del G, Gp, G64
    log(f"  f32 gram_dense at A^T {tuple(At.shape)} "
        f"({At.numel() * 4 / 1e9:.2f} GB): rel err "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (tol {tol:.0e}); max abs against plain {max_abs:.2e}; "
        f"symmetric {sym}")
    if not (all(math.isfinite(e) and e <= tol for e in errs.values())
            and sym):
        raise AssertionError(f"gram_dense at the full shape: {errs}, "
                             f"symmetric {sym}")
    rec = {"name": info.name, "route": "cuda", "source": info.source,
           "replaces": info.replaces, "max_abs_err": max_abs, "m": m, "K": K,
           "dtype": "float32", "errors": errs}
    rec["ms"], rec["clocks"] = sampling_clocks(
        lambda: event_ms(lambda: gk.gram_dense(At), reps))
    rec["plain_ms"] = event_ms(lambda: gk.gram_ref(At), reps)
    rec["library_ms"], rec["library_clocks"] = sampling_clocks(
        lambda: event_ms(lambda: torch.mm(At, At.T), reps))
    rec.update(bound("gram", m, m, K, At.dtype))
    log(f"    device {rec['ms']:.2f} ms, plain {rec['plain_ms']:.2f}, library "
        f"(mm) {rec['library_ms']:.2f}, bound {rec['bound_ms']:.2f} ms "
        f"({rec['bound_by']}); while K8 ran: {rec['clocks']}; while mm "
        f"ran: {rec['library_clocks']}")
    return rec


def sampling_clocks(fn) -> tuple:
    """``fn()`` while nvidia-smi samples the card every 100 ms; returns
    fn's result and the median SM clock (MHz) and power draw (W) of the
    samples, with their count.  For calls of a second or more."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        out = fn()
    finally:
        proc.terminate()
        text, _ = proc.communicate()
    rows = [[float(v) for v in line.split(",")]
            for line in text.splitlines()
            if re.fullmatch(r"\s*[\d.]+\s*,\s*[\d.]+\s*", line)]
    mid = len(rows) // 2
    return out, {"sm_mhz": sorted(r[0] for r in rows)[mid] if rows else None,
                 "power_w": sorted(r[1] for r in rows)[mid] if rows else None,
                 "samples": len(rows)}


def cholqr_split(X, y, lam: float, w_whole) -> dict:
    """The CholeskyQR ridge solve's steps, as ``tsqr_ridge`` takes them,
    each timed to a synchronisation, with each step's peak of device memory
    above what was allocated before the first (X among it): the operand's
    build, K8, the Cholesky factorisation (the operand freed first), the
    right-hand side and two triangular solves."""
    n = X.shape[1]
    times = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()

    def step(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        times[name.replace("_ms", "_peak_gib")] = (
            torch.cuda.max_memory_allocated() - base) / 2**30
        return out

    At = step("build_ms", lambda: ridge_operand(X, lam))
    G = step("gram_ms", lambda: gk.gram(At))
    del At
    R = step("cholesky_ms", lambda: cholesky_nan(G)).T
    del G

    def solves():
        z = torch.linalg.solve_triangular(R.T, (X @ y / n)[:, None],
                                          upper=False)
        return torch.linalg.solve_triangular(R, z, upper=True)[:, 0]

    w = step("solves_ms", solves)
    times["rel_to_whole_solve"] = rel(w, w_whole)
    log("  CholeskyQR solve, step by step (ms; peak GiB above the start): "
        + ", ".join(f"{k} {v:.1e}" if k.startswith("rel") else f"{k} {v:.2f}"
                    for k, v in times.items()))
    return times


def baselines(X, y, lam: float, cut, gen, stats: dict) -> dict:
    """Phase 7: the baselines at real-sim size (counted): the CholeskyQR
    ridge solve through K8; CG through K2 / K6 (impl="cuda") and through
    the dense products (impl=None); CG's history and the TSQR / CholeskyQR
    solves of both branches in f64 on the 8x cuts; K7 on a gathered panel.
    Each solve against the direct solve; then the CholeskyQR solve's time
    split and the device-idle share of a CG solve."""
    d, n = X.shape
    news20 = make_regression(gen, PAPER_DATASETS["news20"], torch.float64,
                             device=X.device)[:2]
    flat = blocked_flat(gen, d, 8, 16)
    u = torch.randn((n,), generator=gen, device=X.device, dtype=X.dtype)
    lams = {name: 1e-6 * float(torch.linalg.norm(data[0]) ** 2)
            for name, data in (("real-sim 8x cut", cut), ("news20 8x cut",
                                                          news20))}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launch_counts()                          # baselines path starts
    t0 = time.perf_counter()
    w_chol = core.tsqr_ridge(X, y, lam, method="cholqr")
    torch.cuda.synchronize()
    chol_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    cg = {}
    for route in ("cuda", None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = core.cg_ridge(X, y, lam, max_iters=CG_MAX_ITERS, impl=route)
        torch.cuda.synchronize()
        cg[route] = (res, time.perf_counter() - t0)
    Xc, yc = cut[:2]
    lam_c = lams["real-sim 8x cut"]
    w_ref_c = core.ridge_exact(Xc, yc, lam_c)
    hist = core.cg_ridge_history(Xc, yc, lam_c, HISTORY_ITERS, w_ref=w_ref_c,
                                 impl="cuda")
    qr = {}
    for name, (Xd, yd) in (("real-sim 8x cut", cut[:2]),
                           ("news20 8x cut", news20)):
        lam_d = lams[name]
        A = ridge_operand(Xd, lam_d).T
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        R_t = core.tsqr(A)
        torch.cuda.synchronize()
        tsqr_s = time.perf_counter() - t0
        R_c = core.cholqr_r(A)
        del A
        qr[name] = {"gram_rel": rel(R_t.T @ R_t, R_c.T @ R_c),
                    "tsqr_s": tsqr_s, "shape": tuple(Xd.shape),
                    "w": {m: core.tsqr_ridge(Xd, yd, lam_d, method=m)
                          for m in ("tsqr", "cholqr")},
                    "exact": core.ridge_exact(Xd, yd, lam_d)}
    G7, r7 = gk.gram_packet(X[flat.long()].contiguous(), u)
    torch.cuda.synchronize()
    counts = launches()  # baselines path ends
    log(f"  launches {counts}")
    want = dict.fromkeys(launches(), 0)
    want.update({"gram_dense": 5, "gram_packet_dense": 1,
                 "panel_apply_rows": cg["cuda"][0].iters + HISTORY_ITERS,
                 "panel_matvec_rows": cg["cuda"][0].iters + HISTORY_ITERS})
    if counts != want:
        raise AssertionError(f"baselines launches {counts}, expected {want}")

    w_exact = core.ridge_exact(X, y, lam)
    e_chol = rel(w_chol, w_exact)
    log(f"  (a) CholeskyQR ridge solve through K8: {chol_s:.3f} s, peak "
        f"{peak:.2f} GiB beside X; |w - w_exact|/|w_exact| {e_chol:.2e} "
        f"(tol {TOL_BASELINE_F32:.0e})")
    stats["cholqr_solve"] = {"wall_s": chol_s, "peak_gib_beside_x": peak,
                             "rel_to_exact": e_chol}
    agree = [e_chol]
    for route, (res, wall) in cg.items():
        e = rel(res.w, w_chol)
        agree.append(e)
        log(f"  (b) CG impl={route!s:4s}: {res.iters} iterations (tol 1e-15, "
            f"at most {CG_MAX_ITERS}), {wall:.3f} s, "
            f"{wall / max(res.iters, 1) * 1e3:.2f} ms per iteration; "
            f"|w - w_cholqr|/|w_cholqr| {e:.2e}, |w - w_exact|/|w_exact| "
            f"{rel(res.w, w_exact):.2e}")
        stats[f"cg_{route}"] = {"iters": res.iters, "wall_s": wall,
                                "ms_per_iter": wall / max(res.iters, 1) * 1e3,
                                "rel_to_cholqr": e}
    if not all(math.isfinite(e) and e <= TOL_BASELINE_F32 for e in agree):
        raise AssertionError(f"baselines disagree at real-sim size: {agree}")
    if not all(res.iters >= 1 for res, _ in cg.values()):
        raise AssertionError("CG took no iteration")

    obj = hist.history["objective"]
    eps = torch.finfo(obj.dtype).eps
    rise = float((obj[1:] / obj[:-1] - 1).max())
    log(f"  (c) CG history, f64 8x-cut real-sim, {HISTORY_ITERS} iterations "
        f"through K2 / K6: objective {float(obj[0]):.12e} -> "
        f"{float(obj[-1]):.12e}, largest relative step up {rise:.1e} (allowed "
        f"{4 * eps:.1e}: past convergence the objective is flat up to its "
        f"own rounding); res_norm {float(hist.history['res_norm'][0]):.2e} "
        f"-> {float(hist.history['res_norm'][-1]):.2e}; sol_err "
        f"{float(hist.history['sol_err'][-1]):.2e}")
    if not (bool(torch.isfinite(obj).all()) and rise <= 4 * eps
            and float(obj[-1]) < float(obj[0])):
        raise AssertionError(f"CG history: the objective rose ({rise})")

    for name, rec in qr.items():
        errs = {"R^T R tsqr vs cholqr": rec["gram_rel"]}
        errs.update({f"{m} vs exact": rel(w, rec["exact"])
                     for m, w in rec["w"].items()})
        log(f"  (d) f64 {name} {rec['shape']}: "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f" (tol {TOL_BASELINE_F64:.0e}); Householder TSQR "
            f"{rec['tsqr_s']:.3f} s")
        stats[f"qr_{name}"] = {"errors": errs, "tsqr_s": rec["tsqr_s"]}
        if not all(math.isfinite(e) and e <= TOL_BASELINE_F64
                   for e in errs.values()):
            raise AssertionError(f"f64 {name}: {errs}")

    G1, r1 = gk.gram_packet_sampled_rows(X, flat, u)
    if not (torch.equal(G7, G1) and torch.equal(r7, r1)):
        raise AssertionError("K7 on the gathered panel differs from K1")
    log("  K7 (ops.gram_packet) on the gathered panel Y = X[flat], m = 128: "
        "equal to K1 on (X, flat) (torch.equal)")

    stats["cholqr_split"] = cholqr_split(X, y, lam, w_chol)
    log("== 7e. where a CG solve's time goes (profiler trace)")
    for route in ("cuda", None):
        stats[f"profile_cg_{route}"] = profile_run(
            lambda: core.cg_ridge(X, y, lam, max_iters=CG_MAX_ITERS,
                                  impl=route),
            f"CG impl={route}", 6)
    return counts


def launches() -> dict:
    return gk.launch_counts()


def ran_since(before: dict) -> dict:
    return {name: n - before[name] for name, n in launches().items()}


def timed(fn) -> tuple:
    """``fn()`` and its wall time in seconds, to a synchronisation."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def same_result(a, b) -> bool:
    """w, alpha and every history series equal under torch.equal."""
    return (torch.equal(a.w, b.w) and torch.equal(a.alpha, b.alpha)
            and sorted(a.history) == sorted(b.history)
            and all(torch.equal(a.history[k], b.history[k])
                    for k in a.history))


def host_metrics(res) -> dict:
    return {k: (v.item() if isinstance(v, torch.Tensor) else v)
            for k, v in res.metrics.items()}


def recovery_run(X, y, lam, cut, gen, iters: int, stats: dict) -> dict:
    """Phase 8: the accelerated formulation, the guards, fault injection and
    the supervised restart at real-sim size, counted; then, off the count,
    the impl="ref" comparisons and the guard's overhead from traces.
    Returns the launch counts of the path."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.faults import FaultPlan, solve_supervised
    d, n = X.shape
    b = 8
    f_iters, sup_iters = FAULT_ITERS, SUPERVISED_ITERS
    longest = max(iters, f_iters, sup_iters)
    stream_p = core.sample_blocks(gen, d, b, longest)
    stream_d = core.sample_blocks(gen, n, b, longest)
    idx_p, idx_d = stream_p[:iters], stream_d[:iters]
    runs = {}
    gk.reset_launch_counts()                          # recovery path starts
    # (a) accelerated: beta = 0 against the primal, beta = 0.9 timed
    for s in (1, 16):
        runs["primal", s], wall_p = timed(
            lambda: core.ca_bcd(X, y, lam, b, s, iters, idx=idx_p))
        runs["beta0", s], _ = timed(lambda: core.ca_accelerated_bcd(
            X, y, lam, b, s, iters, idx=idx_p, beta=0.0))
        before = launches()
        runs["beta.9", s], wall_a = timed(lambda: core.ca_accelerated_bcd(
            X, y, lam, b, s, iters, idx=idx_p, beta=0.9))
        ran = ran_since(before)
        outer = -(-iters // s)
        if (ran["gram_packet_sampled_rows"], ran["panel_apply_rows"]) != (
                outer, iters):
            raise AssertionError(f"accelerated s={s}: launches {ran}")
        stats[f"accelerated_s{s}"] = {
            "wall_s": wall_a, "ms_per_inner": wall_a / iters * 1e3,
            "primal_wall_s": wall_p,
            "primal_ms_per_inner": wall_p / iters * 1e3}
        log(f"  accelerated beta=0.9 s={s:2d}: {wall_a / iters * 1e3:.3f} ms "
            f"an inner iteration (primal {wall_p / iters * 1e3:.3f}); "
            f"beta=0 equals the primal (torch.equal on w, alpha, history) "
            f"{same_result(runs['beta0', s], runs['primal', s])}")
        if not same_result(runs["beta0", s], runs["primal", s]):
            raise AssertionError(f"accelerated beta=0 s={s} differs from "
                                 "the primal")
    # (b) the guard on clean solves: equal to the unguarded, same launches
    for form, solve, idx in (("primal", core.ca_bcd, idx_p),
                             ("dual", core.ca_bdcd, idx_d)):
        before = launches()
        runs[form, "plain"], _ = timed(
            lambda: solve(X, y, lam, b, 16, iters, idx=idx))
        mid = launches()
        runs[form, "guarded"], _ = timed(
            lambda: solve(X, y, lam, b, 16, iters, idx=idx, guard=True))
        plain_ran = {k: mid[k] - before[k] for k in mid}
        guard_ran = ran_since(mid)
        res = runs[form, "guarded"]
        m = host_metrics(res)
        equal = (torch.equal(res.w, runs[form, "plain"].w)
                 and torch.equal(res.alpha, runs[form, "plain"].alpha))
        log(f"  guarded {form:6s} s=16: equal to unguarded (torch.equal on "
            f"w, alpha) {equal}; {m}; launches equal {plain_ran == guard_ran}")
        if not (equal and m["guard_trips"] == 0
                and m["guard_first_trip"] == -1 and plain_ran == guard_ran):
            raise AssertionError(f"guarded clean {form} solve: {equal}, {m}, "
                                 f"{plain_ran} vs {guard_ran}")
    # (c) the fault matrix at s = 16
    faults = {}
    for form, solve, idx in (("primal", core.ca_bcd, stream_p[:f_iters]),
                             ("dual", core.ca_bdcd, stream_d[:f_iters])):
        runs[form, "clean"] = solve(X, y, lam, b, 16, f_iters, idx=idx)
        for kind, step, reason in FAULTS:
            faults[form, kind], wall = timed(lambda: solve(
                X, y, lam, b, 16, f_iters, idx=idx, guard=True,
                fault=FaultPlan(kind, step=step)))
            stats[f"fault_{form}_{kind}_wall_s"] = wall
    # (d) the rescue of a singular block: lam = 0, duplicate rows
    rows = torch.nonzero(torch.linalg.vector_norm(X, dim=1) > 0).flatten()[
        :2].tolist()
    dup = torch.tensor([[rows[0]] * 2, [rows[1]] * 2], dtype=torch.int32,
                       device=X.device).repeat(6, 1)
    rescue_plain = core.ca_bcd(X, y, 0.0, 2, 4, 12, idx=dup)
    rescue_guard = core.ca_bcd(X, y, 0.0, 2, 4, 12, idx=dup, guard=True)
    # (e) the supervised restart, f32 real-sim and f64 on the 8x cut
    sup = {}
    Xc, yc = cut[:2]
    lam_c = 1e-6 * float(torch.linalg.norm(Xc) ** 2)
    idx_c = core.sample_blocks(gen, Xc.shape[0], b, sup_iters)
    with tempfile.TemporaryDirectory() as tmp:
        for tag, (Xs, ys, lam_s, idx_s) in (
                ("f32", (X, y, lam, stream_p[:sup_iters])),
                ("f64", (Xc, yc, lam_c, idx_c))):
            sup[tag], wall = timed(lambda: solve_supervised(
                "primal", "local", Xs, ys, lam_s, b, 16, sup_iters,
                idx=idx_s, ckpt_dir=f"{tmp}/{tag}",
                fault=FaultPlan("device_loss", step=4)))
            sup[tag, "clean"] = core.ca_bcd(Xs, ys, lam_s, b, 16, sup_iters,
                                            idx=idx_s)
            stats[f"supervised_{tag}_wall_s"] = wall
        counts = launches()                           # recovery path ends
        # one snapshot of the f32 iterate, as the supervisor writes it
        mgr = CheckpointManager(f"{tmp}/timing", async_save=False)
        writes = []
        for k in range(5):
            _, wall = timed(lambda: mgr.save(k, {"x0": sup["f32"].w},
                                             block=True))
            writes.append(wall)
        snap = Path(tmp) / "timing" / "step_0000000004"
        nbytes = sum(f.stat().st_size for f in snap.iterdir())
    stats["snapshot"] = {"write_ms": sorted(writes)[2] * 1e3,
                         "writes_ms": [w * 1e3 for w in writes],
                         "bytes": nbytes}
    log(f"  snapshot of the f32 iterate (d = {d}): {nbytes} bytes on disk, "
        f"write {sorted(writes)[2] * 1e3:.3f} ms (median of 5)")
    log(f"  launches {counts}")
    for name in ("gram_packet_sampled_rows", "panel_apply_rows",
                 "gram_packet_sampled_cols", "panel_apply_cols"):
        if counts[name] == 0:
            raise AssertionError(f"{name} never ran on the recovery path")

    # -- checks off the count ------------------------------------------
    f0 = float(0.5 / n * (y @ y))
    for s in (1, 16):
        before = launches()
        ref = core.ca_accelerated_bcd(X, y, lam, b, s, iters, idx=idx_p,
                                      beta=0.9, impl="ref")
        if launches() != before:
            raise AssertionError("impl='ref' launched a CUDA kernel")
        got = runs["beta.9", s]
        hist = got.history["objective"]
        first, last = float(hist[0]), float(hist[-1])
        kr = rel(got.w, ref.w)
        log(f"  accelerated beta=0.9 s={s:2d}: objective {f0:.6e} -> "
            f"{first:.6e} -> {last:.6e}; |w_cuda - w_ref|/|w| {kr:.2e} "
            f"(tol {TOL_SOLVE_F32:.0e})")
        stats[f"accelerated_s{s}"]["cuda_vs_ref"] = kr
        if not (math.isfinite(last) and last < first < f0
                and kr <= TOL_SOLVE_F32):
            raise AssertionError(f"accelerated s={s}: {f0}, {first}, {last}, "
                                 f"{kr}")
    for (form, kind), res in faults.items():
        step, reason = next((st, r) for k, st, r in FAULTS if k == kind)
        m = host_metrics(res)
        o_clean = float(core.objective(X, runs[form, "clean"].w, y, lam))
        o_fault = float(core.objective(X, res.w, y, lam))
        log(f"  fault {kind:10s} at step {step} in the {form:6s}: first trip "
            f"{m['guard_first_trip']}, reason {m['guard_first_reason']}, "
            f"trips {m['guard_trips']}, s=1 tail from outer step "
            f"{m.get('s1_tail_from_outer')} (iteration "
            f"{m.get('s1_tail_from_iter')}, {m.get('s1_tail_trips')} trips "
            f"in it); objective {o_fault:.6e} (clean {o_clean:.6e}); "
            f"{stats[f'fault_{form}_{kind}_wall_s']:.3f} s")
        stats[f"fault_{form}_{kind}"] = {"metrics": m, "objective": o_fault,
                                         "clean_objective": o_clean}
        if not (m["guard_first_trip"] == step
                and int(m["guard_first_reason"]) & reason
                and m.get("s1_tail_from_outer") == step
                and math.isfinite(o_fault)
                and o_fault <= o_clean * 1.25 + 1e-6):
            raise AssertionError(f"fault {kind} in the {form}: {m}, "
                                 f"{o_fault} vs {o_clean}")
    m = host_metrics(rescue_guard)
    plain_finite = bool(torch.isfinite(rescue_plain.w).all())
    guard_finite = bool(torch.isfinite(rescue_guard.w).all())
    log(f"  rescue, rows {rows} duplicated at lam = 0, s = 4: unguarded "
        f"finite {plain_finite}, guarded finite {guard_finite}, {m}")
    stats["rescue"] = {"rows": rows, "unguarded_finite": plain_finite,
                       "metrics": m}
    if plain_finite or not guard_finite or not m["guard_max_jitter"] > 0:
        raise AssertionError(f"rescue: unguarded finite {plain_finite}, "
                             f"guarded finite {guard_finite}, {m}")
    for tag, tol in (("f32", TOL_SUPERVISED_F32),
                     ("f64", TOL_SUPERVISED_F64)):
        res, clean = sup[tag], sup[tag, "clean"]
        err = float((res.w - clean.w).abs().max())
        log(f"  supervised {tag} primal s=16, {sup_iters} iterations, device "
            f"lost at outer step 4: {res.metrics}; max |w - w_uninterrupted| "
            f"{err:.2e} (tol {tol:.0e}); {stats[f'supervised_{tag}_wall_s']:.3f}"
            " s")
        stats[f"supervised_{tag}"] = {"metrics": res.metrics, "max_abs": err}
        if not (res.metrics["restarts"] == 1 and err <= tol):
            raise AssertionError(f"supervised {tag}: {res.metrics}, {err}")
    log("== 8b. the guard's and the momentum's cost (profiler traces, 64 "
        "iterations; primal, guarded, accelerated beta = 0.9 in turns)")
    variants = {"primal": {}, "guarded": {"guard": True},
                "accelerated": {"beta": 0.9}}
    for s in (1, 16):
        for name in ("primal", "guarded", "accelerated", "accelerated",
                     "guarded", "primal"):
            solve = core.ca_accelerated_bcd if name == "accelerated" else (
                core.ca_bcd)
            rec = profile_run(
                lambda: solve(X, y, lam, b, s, 64, idx=stream_p[:64],
                              **variants[name]),
                f"{name} s={s:2d}", 4)
            stats.setdefault(f"phase8_{name}_s{s}", []).append(
                {k: rec[k] for k in ("wall_ms", "busy_ms", "idle")})
    return counts


def compute_mode() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(
        ).splitlines()[0]


def dist_counters(world) -> dict:
    """The last call's wire counters, summed over ranks, with the host ms
    a call (gloo with ranks on one card: host-staged)."""
    cs = world.last["counters"]
    tot = {k: sum(c[k] for c in cs) for k in ("all_reduces", "hops",
                                              "reduce_s", "hop_s")}
    return {"all_reduces": cs[0]["all_reduces"], "hops": cs[0]["hops"],
            "words": cs[0]["words"], "hop_words": cs[0]["hop_words"],
            "ms_per_all_reduce": (tot["reduce_s"] / tot["all_reduces"] * 1e3
                                  if tot["all_reduces"] else None),
            "ms_per_hop": (tot["hop_s"] / tot["hops"] * 1e3
                           if tot["hops"] else None),
            "staged": cs[0]["staged"]}


def check_shard_kernels(X, cut, seed: int) -> None:
    """K1-K6 against their plain versions on the last (zero-padded) rank's
    shard of each layout, the shapes the sharded path launches them at:
    X's n axis cut for the primal family (f32, and f64 on the 8x cut for the
    supervised restart), its d axis for the dual.  A generator of its own
    leaves the phase's data as it was."""
    gen = torch.Generator(device=X.device).manual_seed(seed)
    P = DIST_RANKS
    for tag, Xs, form in (("f32", X, "primal"), ("f32", X, "dual"),
                          ("f64", cut[0], "primal")):
        Xl, _ = engine.FORMULATIONS[form].pad_shards(Xs, None, P, P - 1)
        log(f"  {form} shard {P - 1} of {P} ({tag}): {tuple(Xl.shape)}")
        check_kernels(Xl, gen, f"{tag} {form} shard", (8, 128, 77), 0, {},
                      TENANTS)
        del Xl


def check_sweep_kernels(device, seed: int) -> None:
    """K1-K6 against their plain versions at every shape the contract pass
    launches them at on the card: on its problem's X (d = 16 P, n = 32 P)
    and on the last rank's shard of each layout, in f32 and f64, at the
    packets' and matvecs' m = sb and the ragged tail's m = b (the applies
    at b and sb), the matvecs also with each tenant count the batched cases
    run.  A generator of its own leaves the phase's data as it was."""
    from repro_torch.analysis import contract_pass as cp
    gen = torch.Generator(device=device).manual_seed(seed)
    P = DIST_RANKS
    ms = (cp.B * (cp.ITERS_RAGGED % cp.S), cp.S * cp.B)
    X, _ = cp._problem(cp.D_PER_P * P, cp.N_PER_P * P, torch.float32, device)
    for Xd in (X, X.double()):
        tag = str(Xd.dtype).removeprefix("torch.")
        for what, Xs in [("sweep X", Xd)] + [
                (f"{form} shard {P - 1} of {P}",
                 engine.FORMULATIONS[form].pad_shards(Xd, None, P, P - 1)[0])
                for form in ("primal", "dual")]:
            log(f"  {tag} {what}: {tuple(Xs.shape)}, m in {ms}, tenants "
                f"{cp.TENANTS_SWEPT}")
            check_kernels(Xs, gen, f"{tag} {what}", ms, 0, {},
                          cp.TENANTS_SWEPT[0])
            for T in cp.TENANTS_SWEPT[1:]:
                check_kernels(Xs, gen, f"{tag} {what}", ms, 0, {}, T,
                              kinds=("matvec",))


def distributed_run(X, y, lam, cut, gen, stats: dict, seed: int) -> dict:
    """Phase 9: the kernels on the ranks' shards against their plain
    versions; then the sharded and pipelined backends on a world of
    ``DIST_RANKS`` gloo ranks sharing the card, at real-sim size, counted
    (summed over the ranks): primal and dual at s in {1, 16} on both wires
    against the local solve; the batched engine against single sharded
    solves; guarded clean solves against unguarded ones; the fault matrix
    on shard 1.  Then, off the count, the supervised restart onto 3
    survivors (f32, and f64 on the 8x cut) and one NCCL rank.  Returns the
    path's launch counts."""
    from repro_torch.faults import FaultPlan
    mode = compute_mode()
    log(f"  compute mode: {mode}")
    if mode != "Default":
        raise AssertionError(f"compute mode {mode!r}: {DIST_RANKS} ranks "
                             "cannot share the card")
    check_shard_kernels(X, cut, seed)
    d, n = X.shape
    b, iters, P = 8, DIST_ITERS, DIST_RANKS
    idx = {"primal": core.sample_blocks(gen, d, b, iters),
           "dual": core.sample_blocks(gen, n, b, iters)}
    local_solve = {"primal": core.ca_bcd, "dual": core.ca_bdcd}
    local = {}
    for form in ("primal", "dual"):
        for s in (1, 16):
            local[form, s], wall = timed(lambda: local_solve[form](
                X, y, lam, b, s, iters, idx=idx[form]))
            stats[f"dist_local_{form}_s{s}"] = {
                "wall_s": wall, "ms_per_outer": wall / -(-iters // s) * 1e3}
    world, spawn = timed(lambda: core.SolverWorld(P, backend="gloo",
                                                  device=X.device))
    stats["dist_spawn_s"] = spawn
    log(f"  {P} gloo ranks on {X.device} spawned in {spawn:.2f} s")
    try:
        for form in ("primal", "dual"):       # cut the shards, off the count
            _, wall = timed(lambda: core.get_solver(form, "sharded")(
                world, X, y, lam, b, 1, 1, idx=idx[form][:1]))
            stats[f"dist_shard_{form}_s"] = wall
            log(f"  {form:6s} shards cut in {wall:.2f} s")
        world.reset_counts()                  # the sharded path starts
        runs = {}
        for form in ("primal", "dual"):
            for wire in ("sharded", "pipelined"):
                for s in (1, 16):
                    runs[form, wire, s] = check_sharded(
                        world, form, wire, s, X, y, lam, idx[form],
                        local[form, s], stats)
        batched_sharded(world, X, y, lam, gen, stats)
        for form in ("primal", "dual"):
            solve = core.get_solver(form, "sharded")
            w, alpha, m = solve(world, X, y, lam, b, 16, iters,
                                idx=idx[form], guard=True)
            plain = runs[form, "sharded", 16]
            same = torch.equal(w, plain[0]) and torch.equal(alpha, plain[1])
            c = dist_counters(world)
            log(f"  guarded {form:6s} s=16 on {P} ranks: equal to unguarded "
                f"(torch.equal) {same}; {m}; all-reduces {c['all_reduces']}")
            if not (same and m["guard_trips"] == 0
                    and c["all_reduces"] == -(-iters // 16)):
                raise AssertionError(f"guarded sharded {form}: {same}, {m}, "
                                     f"{c}")
            for kind, step, reason in FAULTS:
                (w, alpha, m), wall = timed(lambda: solve(
                    world, X, y, lam, b, 16, FAULT_ITERS,
                    idx=idx[form][:FAULT_ITERS], guard=True,
                    fault=FaultPlan(kind, step=step, shard=1)))
                log(f"  fault {kind:10s} on shard 1 of {P} at step {step}, "
                    f"{form:6s}: first trip {m['guard_first_trip']}, reason "
                    f"{m['guard_first_reason']}, trips {m['guard_trips']}; "
                    f"{wall:.3f} s")
                stats[f"dist_fault_{form}_{kind}"] = {"metrics": m,
                                                      "wall_s": wall}
                if not (m["guard_first_trip"] == step
                        and m["guard_first_reason"] & reason
                        and bool(torch.isfinite(w).all())):
                    raise AssertionError(f"sharded fault {kind} {form}: {m}")
        counts = {k: sum(r[k] for r in world.launches)
                  for k in world.launches[0]}  # the sharded path ends
        for r, ran in enumerate(world.launches):
            log(f"  rank {r} launches {ran}")
        stats["dist_launches_by_rank"] = [dict(r) for r in world.launches]
        supervised_sharded(world, X, y, lam, cut, gen, stats)
    finally:
        world.close()
    one_nccl_rank(X, y, lam, idx["primal"], local["primal", 16], stats)
    return counts


def check_sharded(world, form, wire, s, X, y, lam, idx, local, stats):
    """One sharded solve on the world, held against the local solve on the
    same stream, with its collectives counted."""
    iters, b = idx.shape
    H = -(-iters // s)
    P = world.size
    (w, alpha), wall = timed(lambda: core.get_solver(form, wire)(
        world, X, y, lam, b, s, iters, idx=idx))
    c = dist_counters(world)
    rank_s = max(world.last["solve_s"])
    ew, ea = rel(w, local.w), rel(alpha, local.alpha)
    want = (H, 0) if wire == "sharded" else (0, 2 * (P - 1) * H)
    k = {name: n for name, n in world.last["launches"][0].items() if n}
    log(f"  {form:6s} {wire:9s} s={s:2d}: {rank_s / H * 1e3:.3f} ms/outer "
        f"step on {P} ranks (local {stats[f'dist_local_{form}_s{s}']['ms_per_outer']:.3f}); "
        f"all-reduces {c['all_reduces']}, hops {c['hops']} (want {want}); "
        f"ms a call, gloo host-staged: all-reduce {c['ms_per_all_reduce']}, "
        f"hop {c['ms_per_hop']}; |dw|/|w| {ew:.2e}, |dalpha|/|alpha| "
        f"{ea:.2e} (tol {TOL_DIST_F32:.0e}); replicas equal "
        f"{world.last['replicas_equal']}; rank 0 launches {k}")
    stats[f"dist_{form}_{wire}_s{s}"] = {
        "wall_s": wall, "rank_solve_s": rank_s,
        "ms_per_outer": rank_s / H * 1e3, "rel_w": ew, "rel_alpha": ea,
        **c}
    if not ((c["all_reduces"], c["hops"]) == want and ew <= TOL_DIST_F32
            and ea <= TOL_DIST_F32 and world.last["replicas_equal"]):
        raise AssertionError(f"sharded {form} {wire} s={s}: {c}, {ew}, {ea}")
    return w, alpha


def batched_sharded(world, X, y, lam, gen, stats) -> None:
    """The batched primal at T = 8, s = 16 on the world's four ranks and on
    two of them, each tenant against its single sharded solve."""
    d = X.shape[0]
    b, s = 8, 16
    ys, lams, _ = tenant_problem(X, y, lam, gen, TENANTS)
    batch = core.TenantBatch(ys=ys, lams=lams)
    plan = core.SolverPlan(b=b, s=s)
    idx = core.sample_blocks(gen, d, b, BATCHED_ITERS)
    H = -(-BATCHED_ITERS // s)
    for P in (world.size, 2):
        ranks = world.ranks(P)
        got, wall = timed(lambda: ranks.solve_batched(
            "primal", plan, X, batch, BATCHED_ITERS, idx=idx))
        c = dist_counters(world)
        errs, equal = [], []
        for t in range(TENANTS):
            w, alpha = ranks.solve("primal", plan, X, ys[t], lams[t],
                                   BATCHED_ITERS, idx=idx)
            errs.append(max(rel(got.ws[t], w), rel(got.alphas[t], alpha)))
            equal.append(torch.equal(got.ws[t], w)
                         and torch.equal(got.alphas[t], alpha))
        log(f"  batched primal T={TENANTS} s={s} on {P} ranks: {wall:.3f} s, "
            f"all-reduces {c['all_reduces']} (want {H}) of {c['words']} "
            f"words; tenants equal to their single sharded solves "
            f"(torch.equal) {sum(equal)}/{TENANTS}, max rel diff "
            f"{max(errs):.2e}"
            + ("" if P <= 2 else f" (tol {TOL_BATCHED_DIST_F32:.0e})"))
        stats[f"dist_batched_P{P}"] = {"wall_s": wall, "equal": sum(equal),
                                       "max_rel": max(errs), **c}
        ok = all(equal) if P <= 2 else max(errs) <= TOL_BATCHED_DIST_F32
        if not (ok and c["all_reduces"] == H):
            raise AssertionError(f"batched sharded P={P}: {equal}, {errs}, "
                                 f"{c}")


def supervised_sharded(world, X, y, lam, cut, gen, stats) -> None:
    """A device loss at outer step 4 of the sharded primal at s = 16: the
    world respawns on 3 survivors and resumes from the newest snapshot
    (f32 at real-sim on the phase's world; f64 on the 8x cut, the
    supervisor's own world)."""
    import tempfile

    from repro_torch.faults import FaultPlan, solve_supervised
    b, s = 8, 16
    Xc, yc = cut[:2]
    lam_c = 1e-6 * float(torch.linalg.norm(Xc) ** 2)
    cases = (("f64", Xc, yc, lam_c, TOL_SUPERVISED_F64),
             ("f32", X, y, lam, TOL_SUPERVISED_F32))
    idx = {tag: core.sample_blocks(gen, Xs.shape[0], b, SUPERVISED_ITERS)
           for tag, Xs, *_ in cases}
    clean = {tag: core.ca_bcd_sharded(world, Xs, ys, lam_s, b, s,
                                      SUPERVISED_ITERS, idx=idx[tag])
             for tag, Xs, ys, lam_s, *_ in cases}
    # f64 on a world of its own first: the f32 run respawns the phase's
    with tempfile.TemporaryDirectory() as tmp, core.SolverWorld(
            DIST_RANKS, backend="gloo", device=X.device) as own:
        for (tag, Xs, ys, lam_s, tol), on in zip(cases, (own, world)):
            res, wall = timed(lambda: solve_supervised(
                "primal", "sharded", Xs, ys, lam_s, b, s, SUPERVISED_ITERS,
                idx=idx[tag], ckpt_dir=f"{tmp}/{tag}", world=on,
                fault=FaultPlan("device_loss", step=4, survivors=3)))
            err = float((res.w - clean[tag][0]).abs().max())
            log(f"  supervised sharded primal {tag} s={s}, "
                f"{SUPERVISED_ITERS} iterations, device lost at outer step "
                f"4, resumed on 3 ranks: {res.metrics}; max |w - "
                f"w_uninterrupted| {err:.2e} (tol {tol:.0e}); {wall:.3f} s")
            stats[f"dist_supervised_{tag}"] = {"metrics": res.metrics,
                                               "max_abs": err, "wall_s": wall}
            if not (res.metrics["restarts"] == 1
                    and res.metrics["final_n_shards"] == 3 and err <= tol):
                raise AssertionError(f"supervised sharded {tag}: "
                                     f"{res.metrics}, {err}")


def one_nccl_rank(X, y, lam, idx, local, stats) -> None:
    """A sharded primal at s = 16 on a world of one NCCL rank."""
    b, s = 8, 16
    iters = idx.shape[0]
    H = -(-iters // s)
    with core.SolverWorld(1, backend="nccl", device=X.device) as w1:
        (w, alpha), wall = timed(lambda: core.ca_bcd_sharded(
            w1, X, y, lam, b, s, iters, idx=idx))
        c = dist_counters(w1)
        err = rel(w, local.w)
    log(f"  one NCCL rank: primal s={s}, {wall:.3f} s, all-reduces "
        f"{c['all_reduces']} (want {H}), hops {c['hops']}, staged "
        f"{c['staged']}; |dw|/|w| against the local solve {err:.2e}")
    stats["dist_nccl"] = {"wall_s": wall, "rel_w": err, **c}
    if not (c["all_reduces"] == H and c["hops"] == 0 and not c["staged"]
            and err <= TOL_DIST_F32):
        raise AssertionError(f"one NCCL rank: {c}, {err}")


def contract_engine(X, y, lam, stats: dict, seed: int) -> dict:
    """Phase 10: the plan pass against the card's shared-memory limit, the
    kernels against their plain versions at the contract pass's shapes, the
    contract pass on four gloo ranks sharing the card with the memory
    checks at real-sim size, the cost model against phases 3 and 9, and
    the snapshot cadence.  Any violation raises.  Returns the path's launch
    counts (this process and the ranks)."""
    from repro_torch.analysis import (run_contract_pass, run_memory_checks,
                                      run_plan_pass)
    from repro_torch.core import cost_model as cm
    from repro_torch.kernels.gram.sampled_kernel import SMEM_PER_BLOCK
    d, n = X.shape
    b = 8
    # (a) the budget the plan pass checks against, and the pass
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    plan, wall = timed(run_plan_pass)
    log(f"  (a) SMEM_PER_BLOCK {SMEM_PER_BLOCK}, the card's opt-in limit "
        f"{optin}: {'equal' if optin == SMEM_PER_BLOCK else 'DIFFERENT'}; "
        f"plan pass {len(plan.cases)} cases, {len(plan.violations)} "
        f"violations, {wall:.2f} s")
    if optin != SMEM_PER_BLOCK or not plan.ok:
        raise AssertionError(f"plan pass: optin {optin}\n" + plan.to_json())
    # (b) the kernels at the sweep's shapes (the memory checks' real-sim
    # shapes are phase 2's and 9's), off the count; then the contract pass
    # and the memory checks, counted
    _, wall = timed(lambda: check_sweep_kernels(X.device, seed))
    log(f"  (b) K1-K6 against their plain versions at the sweep's shapes in "
        f"{wall:.2f} s")
    gk.reset_launch_counts()                    # the contracts path starts
    world, spawn = timed(lambda: core.SolverWorld(DIST_RANKS, backend="gloo",
                                                  device=X.device))
    try:
        world.reset_counts()
        rep, sweep_s = timed(lambda: run_contract_pass(world))
        n_sweep = len(rep.cases)
        _, mem_s = timed(lambda: run_memory_checks(world, X, y, lam, rep))
        ranks = [dict(r) for r in world.launches]
    finally:
        world.close()
    counts = {k: v + sum(r[k] for r in ranks)
              for k, v in launches().items()}
    for case in rep.cases[n_sweep:]:
        log(f"    {case}")
    log(f"  (b) {DIST_RANKS} gloo ranks spawned in {spawn:.2f} s; contract "
        f"pass {n_sweep} cases in {sweep_s:.2f} s, memory checks "
        f"{len(rep.cases) - n_sweep} cases at real-sim in {mem_s:.2f} s; "
        f"{len(rep.skipped)} skipped; {len(rep.violations)} violations; "
        f"launches {counts}")
    stats["phase10_contracts"] = {
        "cases": len(rep.cases), "sweep_s": sweep_s, "memory_s": mem_s,
        "spawn_s": spawn, "skipped": rep.skipped, "launches": counts}
    if not rep.ok:
        raise AssertionError("contract pass:\n" + rep.summary())
    # (c) the cost model against the card: one outer step, the model's
    # serial step (compute at 67 TFLOP/s f32, FMA = 2 flops, plus the tree
    # all-reduce), beside the HBM term of the packet alone
    pts = [(s * b * (s * b + 1) + engine.HEALTH_WORDS,
            stats[f"dist_{form}_sharded_s{s}"]["ms_per_all_reduce"] / 1e3)
           for form in ("primal", "dual") for s in (1, 16)]
    alpha, beta = cm.fit_wire(pts, DIST_RANKS)
    refit = cm.MachineModel("h100-gloo-1card, this run", cm.H100_GLOO.gamma,
                            alpha, beta)
    log(f"  (c) gloo wire on {DIST_RANKS} ranks refitted to this run's "
        f"all-reduces {[(w, round(t * 1e3, 3)) for w, t in pts]}: alpha "
        f"{alpha:.4e} s, beta {beta:.4e} s/word (committed alpha "
        f"{cm.H100_GLOO.alpha:.4e} s, beta {cm.H100_GLOO.beta:.4e}: the "
        "payload's effect is not resolved on one card)")
    model = {"alpha": alpha, "beta": beta}
    for form in ("primal", "dual"):
        K = n if form == "primal" else d
        for s in (1, 16):
            for P, machine, key in (
                    (1, cm.H100_LOCAL, f"{form}_s{s}"),
                    (DIST_RANKS, cm.H100_GLOO, f"dist_{form}_sharded_s{s}"),
                    (DIST_RANKS, refit, f"dist_{form}_sharded_s{s}")):
                sch = cm.pipeline_schedule(machine, d=d, n=n,
                                           axis_sizes=(P,), b=b, s=s,
                                           formulation=form)
                pred = (sch["t_compute"] + sch["t_wire_psum"]) * 1e3
                hbm = cm.packet_memory_time(
                    s * b, -(-K // P), cm.H100_HBM_BYTES_PER_S) * 1e3
                meas = stats[key]["ms_per_outer"]
                log(f"      {form:6s} s={s:2d} P={P} {machine.name:26s} "
                    f"predicted {pred:.4f} ms/outer step (HBM term "
                    f"{hbm:.4f}), measured {meas:.4f} (phase "
                    f"{3 if P == 1 else 9}), measured/predicted "
                    f"{meas / pred:.1f}")
                model[f"{machine.name}:{form}_s{s}"] = {
                    "predicted_ms": pred, "hbm_ms": hbm, "measured_ms": meas}
    # (d) the snapshot cadence from this run's times
    t_snap = stats["snapshot"]["write_ms"] / 1e3
    t_step = stats["primal_s16"]["ms_per_outer"] / 1e3
    cad = cm.snapshot_cadence(cm.H100_LOCAL, d=d, n=n, P=1, b=b, s=16,
                              mtbf_outer=MTBF_OUTER, t_snap=t_snap,
                              t_step=t_step)
    log(f"  (d) snapshot cadence (Young): write {t_snap * 1e3:.3f} ms "
        f"(phase 8), primal s=16 step {t_step * 1e3:.3f} ms (phase 3), "
        f"mtbf {MTBF_OUTER:.0e} outer steps: checkpoint every "
        f"{cad['cadence']} outer steps, overhead {cad['overhead']:.2e}")
    stats["phase10_model"] = model
    stats["phase10_cadence"] = cad
    return counts


# Phase 11: the LM at llama3.2-3b's full width.  Its random weights follow
# the reference's init (fan-in = the last-but-one axis: wq / wk scaled by
# the 24 heads, not the 3072 inputs they contract), so queries are ~11x
# and attention scores ~200x wider than in a trained model and the depth
# amplifies any rounding: at full width the f32 forward departs from the
# f64 forward by 1.9e-6 of the largest logit at 1 layer, 6.2e-6 at 2 and
# 3.1e-3 at 4 (CPU, llama3.2-3b cut in depth), about 1 at 28.  So the f32
# exactness gates run at full width cut to LM_EXACT_LAYERS layers, and at
# full depth the same gates run in f64 (its unit is 2^29 times f32's),
# with f32's distance from f64 reported.  The gates: logits of prefill +
# decode against forward, and the engine's greedy tokens against the
# step-by-step oracle, at the reference's rtol / atol 1e-3
# (tests/test_decode.py).  Online-softmax attention against the
# materialised softmax: atol 2e-5 on outputs of order 1.  bf16 against f32
# logits on the same weights, at the cut depth: the depth amplifies bf16's
# rounding as it does f32's, so the yardstick is the f32 model with its
# weights rounded to bf16 (f32 arithmetic): bf16 may depart from f32 by at
# most BF16_OVER_WEIGHTS times as much as that model does (the CPU at full
# width, on these prompts, reads 0.174 against 0.087 at 1 layer, 2.0x, and
# 0.418 against 0.365 at 2 layers, 1.14x); and a top-1 disagreement passes
# only where the f32 top-2 margin is below twice the measured largest logit
# error.
LM_EXACT_LAYERS = 2
LM_TOL = 1e-3
ATTN_TOL = 2e-5
BF16_OVER_WEIGHTS = 3.0
# bf16 serving: 4 slots, 8 requests of mixed length (prefill buckets 32,
# 64, 128 and 256 from min_bucket 32; queueing past the 4 slots), 32 new
# tokens each; weight-read bound of one decode step at 3.35 TB/s.
SERVE_SLOTS = 4
SERVE_PROMPTS = (16, 200, 37, 90, 130, 23, 64, 170)
SERVE_NEW = 32
SERVE_MAX_SEQ = 256


def materialised_attention(q, k, v, causal: bool = True):
    """softmax(q k^T / sqrt(Dh)) v with the whole score matrix in f32, GQA
    heads grouped as the reference groups them."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    qr = q.reshape(B, S, Hkv, H // Hkv, Dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float()) / math.sqrt(Dh)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, S, H, Dh).to(q.dtype)


def top2_margin(logits) -> float:
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


LM_BATCH = (2, 64)                # B, S of prefill + decode against forward


def lm_batch(cfg, device) -> dict:
    from repro_torch.data import synthetic_lm_batch
    B, S = LM_BATCH
    return {k: torch.from_numpy(v).to(device)
            for k, v in synthetic_lm_batch(cfg.vocab, S, B).items()}


def prefill_decode(cfg, model, batch) -> tuple:
    """Forward's logits at the last two positions, and the logits of
    prefill of S - 1 tokens and of one decode step after it."""
    from repro_torch.models import api
    B, S = batch["tokens"].shape
    full, _ = api.forward(model, cfg, batch)
    pre = dict(batch, tokens=batch["tokens"][:, :S - 1])
    logits_pre, cache = api.prefill(model, cfg, pre, max_seq=S)
    logits_dec, _ = api.decode_step(model, cfg, cache, batch["tokens"][:, -1],
                                    torch.full((B,), S - 1,
                                               device=model.device))
    return full[:, S - 2:], logits_pre, logits_dec


def check_chunked_attention(cfg, device, gen) -> None:
    """11a: chunked attention against the materialised softmax at a ragged
    length, in f32, at the model's head counts."""
    from repro_torch.models import layers
    Sr = 333
    q = torch.randn((1, Sr, cfg.n_heads, cfg.resolved_head_dim),
                    generator=gen, device=device)
    k = torch.randn((1, Sr, cfg.n_kv_heads, cfg.resolved_head_dim),
                    generator=gen, device=device)
    v = torch.randn_like(k)
    for causal in (True, False):
        got = layers.chunked_attention(q, k, v, causal=causal, block_q=64,
                                       block_kv=128)
        err = float((got - materialised_attention(q, k, v, causal))
                    .abs().max())
        log(f"  11a chunked attention (S={Sr}, blocks 64 x 128, "
            f"{cfg.n_heads} heads over {cfg.n_kv_heads}, causal {causal}) "
            f"against the materialised softmax: max abs err {err:.2e} (tol "
            f"{ATTN_TOL:.0e})")
        if not err <= ATTN_TOL:
            raise AssertionError(f"chunked attention: {err}")


def lm_exactness(cfg, model) -> tuple:
    """11a, in the model's dtype: prefill of S - 1 tokens and one decode
    step against forward (B = 2, S = 64); the engine's greedy tokens
    against the step-by-step greedy forward.  Returns
    :func:`prefill_decode`'s logits."""
    from repro_torch.models import api
    from repro_torch.serve import Engine, ServeConfig
    B, S = LM_BATCH
    dtype = str(cfg.dtype).removeprefix("torch.")
    full, logits_pre, logits_dec = prefill_decode(
        cfg, model, lm_batch(cfg, model.device))
    errs = []
    for got, want in ((logits_pre, full[:, 0]), (logits_dec, full[:, 1])):
        bad = (got - want).abs() > LM_TOL + LM_TOL * want.abs()
        errs.append((float((got - want).abs().max()), int(bad.sum())))
    log(f"  11a {cfg.n_layers} layers: prefill + decode against forward "
        f"(B={B}, S={S}, {dtype}): max abs err prefill {errs[0][0]:.2e}, "
        f"decode {errs[1][0]:.2e} (rtol / atol {LM_TOL:.0e}; entries outside: "
        f"{errs[0][1]}, {errs[1][1]}; largest logit "
        f"{float(full.abs().max()):.3f})")
    if any(n for _, n in errs):
        raise AssertionError(f"prefill + decode differ from forward: {errs}")
    prompts, new = [[5, 6, 7, 8], [1, 2, 3]], 8
    eng = Engine(cfg, model, ServeConfig(max_seq=128, slots=2,
                                         min_bucket=16))
    outs = eng.generate(prompts, new)
    for i, prompt in enumerate(prompts):
        toks = list(prompt)
        for step in range(new):
            logits, _ = api.forward(model, cfg, {"tokens": torch.tensor(
                [toks], device=model.device)})
            last = logits[0, -1, :cfg.vocab]
            oracle = int(torch.argmax(last))
            if outs[i][step] != oracle:
                margin = top2_margin(last)
                tol = LM_TOL + LM_TOL * float(last.abs().max())
                log(f"  11a request {i} step {step}: engine {outs[i][step]}"
                    f", oracle {oracle}, the oracle's top-2 margin "
                    f"{margin:.3e} (logit tolerance {tol:.3e})")
                if not margin < tol:
                    raise AssertionError(f"the engine departs from the "
                                         f"greedy oracle at request {i} "
                                         f"step {step}")
                break
            toks.append(oracle)
        log(f"  11a engine request {i} (prompt {prompt}): {outs[i]}; greedy "
            f"oracle agrees on {step + 1 if outs[i][step] == oracle else step}"
            f" of {new} tokens")
    return full, logits_pre, logits_dec


def lm_full_depth(cfg, model, stats: dict) -> None:
    """11a at full depth: the gates of :func:`lm_exactness` in f64 on an
    f64 copy of the weights; then, reported, f32 prefill + decode against
    forward, each against the f64 forward, beside the f32 forward's own
    distance from f64 (how far the depth carries f32's rounding)."""
    model64 = model.cast(torch.float64)
    full64, _, _ = lm_exactness(model64.cfg, model64)
    del model64
    full, pre, dec = prefill_decode(cfg, model, lm_batch(cfg, model.device))
    top = float(full64.abs().max())
    d = {"forward32": float((full - full64).abs().max()) / top,
         "prefill32": float((pre - full64[:, 0]).abs().max()) / top,
         "decode32": float((dec - full64[:, 1]).abs().max()) / top,
         "decode_vs_forward32": float((dec - full[:, 1]).abs().max()) / top}
    log(f"  11a {cfg.n_layers} layers, f32 (reported), relative to the "
        f"largest f64 logit {top:.3f}: f32 forward against f64 forward "
        f"{d['forward32']:.3e}; f32 prefill {d['prefill32']:.3e} and decode "
        f"{d['decode32']:.3e} against f64 forward; f32 decode against f32 "
        f"forward {d['decode_vs_forward32']:.3e}")
    stats["lm_depth"] = d


def logit_agreement(cfg, model, logits32: dict, tag: str) -> dict:
    """A model's last-position logits on the serving prompts against the
    f32 model's: the largest error relative to the largest f32 logit, the
    worst relative Frobenius error, top-1 agreement and, for each
    disagreement, the f32 top-2 margin beside the largest error."""
    from repro_torch.models import api
    prompts = serve_prompts(cfg.vocab, 11)
    worst, fro, agree, dis = 0.0, 0.0, 0, []
    for i, prompt in enumerate(prompts):
        lg, _ = api.prefill(model, cfg, {"tokens": torch.tensor(
            [prompt], device=model.device)})
        lg = lg[0, :cfg.vocab].float()
        l32 = logits32[i]
        err = float((lg - l32).abs().max())
        worst = max(worst, err / float(l32.abs().max()))
        fro = max(fro, rel(lg, l32))
        if int(torch.argmax(lg)) == int(torch.argmax(l32)):
            agree += 1
        else:
            dis.append((i, top2_margin(l32), err))
    log(f"  11b {cfg.n_layers} layers, {tag} against f32 last-position "
        f"logits over {len(prompts)} prompts: max relative error "
        f"{worst:.3e} (relative Frobenius, worst prompt {fro:.3e}), top-1 "
        f"agreement {agree} of {len(prompts)}"
        + "".join(f"; prompt {i}: f32 top-2 margin {m:.3e}, max abs err "
                  f"{e:.3e}" for i, m, e in dis))
    return {"rel_err": worst, "rel_fro": fro, "top1_agree": agree,
            "disagree": dis}


def bf16_agreement(model16, logits32: dict, gate: bool) -> dict:
    """bf16 against f32 logits, beside the f32 model with bf16-rounded
    weights; ``gate`` holds bf16 to BF16_OVER_WEIGHTS times the latter and
    to the margin rule."""
    model_w = model16.cast(torch.float32)
    weights = logit_agreement(model_w.cfg, model_w, logits32,
                              "f32 on bf16-rounded weights")
    del model_w
    bf16 = logit_agreement(model16.cfg, model16, logits32, "bf16")
    bound = BF16_OVER_WEIGHTS * weights["rel_err"]
    log(f"    bf16 / rounded-weights error {bf16['rel_err'] / weights['rel_err']:.2f}"
        + (f" (gate {BF16_OVER_WEIGHTS}x: {bound:.3e}); every top-1 "
           f"disagreement within twice its error of the f32 top-2 margin "
           f"{all(m < 2 * e for _, m, e in bf16['disagree'])}"
           if gate else " (not gated)"))
    if gate and (not bf16["rel_err"] <= bound
                 or any(m >= 2 * e for _, m, e in bf16["disagree"])):
        raise AssertionError(f"bf16 logits depart from f32: {bf16}, "
                             f"rounded weights {weights}")
    return {"bf16": bf16, "rounded_weights": weights}


def f32_logits(cfg, model) -> dict:
    """The f32 model's last-position logits on the serving prompts."""
    from repro_torch.models import api
    out = {}
    for i, prompt in enumerate(serve_prompts(cfg.vocab, 11)):
        l32, _ = api.prefill(model, cfg, {"tokens": torch.tensor(
            [prompt], device=model.device)})
        out[i] = l32[0, :cfg.vocab]
    return out


def lm_probe_run(cfg, model, gen, stats: dict, seed: int) -> dict:
    """11c: the LM probe on the f32 model's features (X 3072 x 1024 in
    f64): first K3 / K4 against their plain versions on that X at the m's
    the probe launches them at (b and sb), off the count; then the probe
    through K3 / K4, counted; CA-BDCD against BDCD within 1e-8."""
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.launch import lm_probe
    batch = synthetic_lm_batch(cfg.vocab, seq_len=128, batch=8, seed=3)
    X, y = lm_probe.design(cfg, model, batch)
    check_kernels(X, torch.Generator(device=X.device).manual_seed(seed),
                  "f64 probe X", (lm_probe.B, lm_probe.S * lm_probe.B), 0,
                  {}, TENANTS, kinds=("packet", "apply"), layouts=("cols",))
    gk.reset_launch_counts()
    out, secs = timed(lambda: lm_probe.fit(X, y, gen))
    counts = launches()
    log(f"  11c LM probe: X {out['d']} x {out['n']} (f64), lambda "
        f"{out['lam']:.3e}, b = {lm_probe.B}, s = {lm_probe.S}, "
        f"{out['iters']} iterations, {secs:.2f} s")
    log(f"    CA-BDCD against BDCD: max |w diff| {out['dev']:.2e} (gate "
        f"1e-8); solution error against ridge_exact {out['err']:.3e}; train "
        f"accuracy {out['acc']:.3f}; reductions {out['iters']} (classical) "
        f"against {out['iters'] // out['s']} (CA)")
    log(f"    launches: K3 {counts[gk.COLS_PACKET.name]}, K4 "
        f"{counts[gk.COLS_APPLY.name]} (all: {counts})")
    stats["lm_probe"] = {k: v for k, v in out.items()
                         if k not in ("classical", "ca")} | {"s_wall": secs}
    if not out["dev"] < 1e-8:
        raise AssertionError(f"probe: CA-BDCD differs from BDCD by "
                             f"{out['dev']:.2e}")
    return counts


def serve_prompts(vocab: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, size=n)))
            for n in SERVE_PROMPTS]


def lm_serving(cfg16, model16, logits32: dict, stats: dict) -> None:
    """11b: bf16 serving at full width: bf16 against f32 logits (reported),
    prefill ms per bucket, decode ms per step beside the weight-read bound,
    tokens/s, the decode's device-idle share, the allocator's peak."""
    from repro_torch.models import api
    from repro_torch.models.module import param_bytes
    from repro_torch.serve import Engine, ServeConfig
    weights = param_bytes(api.param_specs(cfg16))
    bound_ms = weights / HBM_BYTES_PER_S * 1e3
    prompts = serve_prompts(cfg16.vocab, 11)
    agreement = bf16_agreement(model16, logits32, gate=False)
    # serving, timed: a warm-up request first (not timed)
    eng = Engine(cfg16, model16, ServeConfig(max_seq=SERVE_MAX_SEQ,
                                             slots=SERVE_SLOTS))
    eng.generate([prompts[0][:8]], 2)
    prefill_ms, decode_ms = {}, []
    inner_prefill, inner_decode = eng._prefill, eng._decode

    def timed_prefill(tokens):
        out, secs = timed(lambda: inner_prefill(tokens))
        prefill_ms.setdefault(tokens.shape[1], []).append(secs * 1e3)
        return out

    def timed_decode(tok, pos):
        out, secs = timed(lambda: inner_decode(tok, pos))
        decode_ms.append(secs * 1e3)
        return out

    eng._prefill, eng._decode = timed_prefill, timed_decode
    torch.cuda.reset_peak_memory_stats()
    outs, secs = timed(lambda: eng.generate(prompts, SERVE_NEW))
    peak = torch.cuda.max_memory_allocated()
    # the timers close over the engine's own methods: drop them, or the
    # cycle keeps the engine, its model and its cache alive into the next
    # phase until a garbage collection
    del eng._prefill, eng._decode
    ntok = sum(len(o) for o in outs)
    if [len(o) for o in outs] != [SERVE_NEW] * len(prompts):
        raise AssertionError(f"serving: token counts {[len(o) for o in outs]}")
    steady = sorted(decode_ms)[len(decode_ms) // 2]
    log(f"  11b serving (bf16, {cfg16.name}, weights {weights / 1e9:.3f} GB):"
        f" {len(prompts)} requests (prompts {list(SERVE_PROMPTS)}) x "
        f"{SERVE_NEW} tokens through {SERVE_SLOTS} slots in {secs:.3f} s: "
        f"{ntok / secs:.1f} tok/s aggregate; {len(decode_ms)} decode steps")
    for bucket, ms in sorted(prefill_ms.items()):
        log(f"    prefill bucket {bucket:4d}: {len(ms)} calls, ms "
            + ", ".join(f"{t:.2f}" for t in ms))
    log(f"    decode ms a step (all {SERVE_SLOTS} slots, host clock to a "
        f"synchronise): median {steady:.3f}, min {min(decode_ms):.3f}, max "
        f"{max(decode_ms):.3f}; weight-read bound {bound_ms:.3f} ms "
        f"(median / bound {steady / bound_ms:.2f})")
    log(f"    peak allocated {peak / 2**30:.2f} GiB")
    # the decode's device-idle share: eight steps of all slots, traced
    tok = torch.ones((SERVE_SLOTS,), dtype=torch.long, device=model16.device)
    pos = torch.full((SERVE_SLOTS,), 100, device=model16.device)
    cache = api.init_cache(cfg16, SERVE_SLOTS, SERVE_MAX_SEQ, model16.device)
    prof = profile_run(lambda: [api.decode_step(model16, cfg16, cache, tok,
                                                pos) for _ in range(8)],
                       "11b decode, 8 steps of 4 slots (bf16)", 6)
    stats["lm_serve"] = {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
                         "decode_ms_median": steady, "bound_ms": bound_ms,
                         "tok_s": ntok / secs, "wall_s": secs,
                         "peak_bytes": peak, "bf16": agreement,
                         "decode_profile": prof}


def lm_phase(seed: int, stats: dict) -> dict:
    """Phase 11: llama3.2-3b at its published width, random weights from
    ``seed``.  At LM_EXACT_LAYERS layers: (a) the f32 exactness gates and
    the bf16 logit gate.  At full depth: (a) the exactness gates in f64,
    and f32 reported against the f64 forward, (c) the LM probe through
    K3 / K4, then (b) bf16 serving.  Returns the probe's launch counts."""
    import dataclasses

    from repro_torch.launch.lm_probe import probe_config
    from repro_torch.models import DecoderLM
    dev = torch.device("cuda")
    cfg = probe_config(full=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cut = dataclasses.replace(cfg, n_layers=LM_EXACT_LAYERS)
    model = DecoderLM.init(cut, gen)
    check_chunked_attention(cut, dev, gen)
    lm_exactness(cut, model)
    model16 = model.cast(torch.bfloat16)
    stats["lm_bf16_cut"] = bf16_agreement(model16,
                                          f32_logits(cut, model), gate=True)
    del model, model16
    model, secs = timed(lambda: DecoderLM.init(cfg, gen))
    log(f"  {cfg.name}: {sum(p.numel() for p in model.parameters())} "
        f"parameters, f32 {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated, initialised in {secs:.2f} s")
    lm_full_depth(cfg, model, stats)
    counts = lm_probe_run(cfg, model, gen, stats, seed)
    logits32 = f32_logits(cfg, model)
    model16 = model.cast(torch.bfloat16)
    del model
    torch.cuda.empty_cache()
    lm_serving(model16.cfg, model16, logits32, stats)
    return counts

# Phase 12: the other bodies at their published widths, random weights from
# --seed: mamba2-370m (ssm), phi3.5-moe-42b (moe), seamless-m4t-large-v2
# (encoder-decoder) and jamba-1.5-large's hybrid interleave.  Every gate is
# collected and the phase fails at its end if any gate failed, so one run
# reports every number.  The gates: prefill + decode against forward and
# the greedy engine (or, for the encoder-decoder, a greedy loop of
# decode_step) against the step-by-step greedy forward, at the reference's
# rtol / atol 1e-3 (tests/test_decode.py), a top-1 disagreement passing only
# where the oracle's top-2 margin is inside that tolerance (as in 11a); the
# chunked SSD scan against the token-by-token recurrence at the reference's
# 2e-4 (tests/test_mamba.py).  f64 models keep the reference's f32 islands
# (mamba's scan and state, the MoE router and combine).  Cuts, and why:
# phi3.5-moe's 32 layers hold 2.52 GB of bf16 experts each (83 GB in all,
# more than the card), so it serves at MOE_SERVE_LAYERS layers and gates at
# MOE_GATE_LAYERS (f32 and f64); seamless gates in f32 at SEAMLESS_F32_LAYERS
# encoder and decoder layers, as llama in 11a (the random init's attention
# amplifies rounding with depth), and in f64 at full depth; jamba-1.5-large's
# one superblock of 8 layers is 88 GB in bf16, so its interleave runs at its
# reduced() widths.
SSD_TOL = 2e-4
MOE_SERVE_LAYERS = 8
MOE_GATE_LAYERS = 2
MOE_GATE_CAPACITY = 4.0
SEAMLESS_F32_LAYERS = 2
SSM_PROMPTS = (256, 512, 256, 512, 512, 256, 512, 256)   # mamba2 serving
FAMILY_SERVE_NEW = 32
ORACLE_NEW = 8


class Gates:
    """Phase 12's gates: each logged as it is read, all checked at the end."""

    def __init__(self):
        self.failed = []

    def check(self, name: str, ok: bool, detail: str) -> bool:
        log(f"    gate {name}: {'ok' if ok else 'FAILED'} ({detail})")
        if not ok:
            self.failed.append(name)
        return ok


def family_batch(cfg, device, gen, B: int = 2, S: int = 64) -> dict:
    """B rows of S tokens; the audio family also gets S // 4 encoder frames
    (0.1 N(0, 1), the reference's stub frontend's rate)."""
    from repro_torch.data import synthetic_lm_batch
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in synthetic_lm_batch(cfg.vocab, S, B).items()}
    if cfg.family == "audio":
        batch["src_embeds"] = 0.1 * torch.randn(
            (B, S // 4, cfg.d_model), generator=gen, device=device)
    return batch


def gate_prefill_decode(gates, tag: str, cfg, model, batch) -> dict:
    """Prefill of S - 1 tokens and one decode step against forward."""
    full, pre, dec = prefill_decode(cfg, model, batch)
    errs, bad = [], 0
    for got, want in ((pre, full[:, 0]), (dec, full[:, 1])):
        errs.append(float((got - want).abs().max()))
        bad += int(((got - want).abs() > LM_TOL + LM_TOL * want.abs()).sum())
    gates.check(f"{tag} prefill + decode == forward", bad == 0,
                f"{cfg.n_layers} layers, {str(cfg.dtype)[6:]}, B x S = "
                f"{tuple(batch['tokens'].shape)}: max abs err prefill "
                f"{errs[0]:.2e}, decode {errs[1]:.2e}, largest logit "
                f"{float(full.abs().max()):.3f}; entries outside rtol / atol "
                f"{LM_TOL:.0e}: {bad}")
    return {"prefill_err": errs[0], "decode_err": errs[1],
            "top": float(full.abs().max())}


def oracle_tokens(cfg, model, prompt: list, new: int, extra=None) -> tuple:
    """Step-by-step greedy decoding through forward: the tokens and, per
    step, the last logits (for the margin rule)."""
    from repro_torch.models import api
    toks, lasts = list(prompt), []
    for _ in range(new):
        batch = {"tokens": torch.tensor([toks], device=model.device)}
        if extra:
            batch.update(extra)
        logits, _ = api.forward(model, cfg, batch)
        lasts.append(logits[0, -1, :cfg.vocab])
        toks.append(int(torch.argmax(lasts[-1])))
    return toks[len(prompt):], lasts


def tokens_agree(gates, tag: str, got: list, want: list, lasts) -> None:
    """Greedy tokens against the oracle's; a first disagreement passes only
    where the oracle's top-2 margin lies inside the logit tolerance."""
    for step, (a, b) in enumerate(zip(got, want)):
        if a != b:
            last = lasts[step]
            margin = top2_margin(last)
            tol = LM_TOL + LM_TOL * float(last.abs().max())
            gates.check(tag, margin < tol,
                        f"first disagreement at step {step}: {a} against "
                        f"{b}, the oracle's top-2 margin {margin:.3e} "
                        f"(logit tolerance {tol:.3e}); tokens {got}")
            return
    gates.check(tag, len(got) == len(want),
                f"{len(got)} of {len(want)} tokens equal: {got}")


def gate_engine(gates, tag: str, cfg, model, prompts, slots: int = 2,
                max_seq: int = 1024) -> None:
    """The engine's greedy tokens against the oracle, prompt by prompt."""
    from repro_torch.serve import Engine, ServeConfig
    eng = Engine(cfg, model, ServeConfig(max_seq=max_seq, slots=slots,
                                         min_bucket=16))
    outs = eng.generate(prompts, ORACLE_NEW)
    for i, prompt in enumerate(prompts):
        want, lasts = oracle_tokens(cfg, model, prompt, ORACLE_NEW)
        tokens_agree(gates, f"{tag} engine request {i} ({len(prompt)} "
                     f"prompt tokens) == greedy oracle", outs[i], want, lasts)


def ssm_prompts(vocab: int, lengths, seed: int) -> list:
    """Prompts of distinct random tokens: on a constant prompt a replayed
    last token would go unseen (ROADMAP.md, queue 3)."""
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, size=n))) for n in lengths]


def gate_ssd(gates, cfg, device, gen) -> dict:
    """The chunked SSD scan against the token-by-token recurrence at the
    block's full width (B = 1, L = 2 chunks, its heads, head dim and
    state), in f32 on the card, both also against the f64 recurrence."""
    from repro_torch.models import mamba2
    s = cfg.ssm
    H, L = s.n_heads(cfg.d_model), 2 * s.chunk
    xdt = 0.5 * torch.randn((1, L, H, s.head_dim), generator=gen,
                            device=device)
    dtA = -(0.1 * torch.randn((1, L, H), generator=gen, device=device)).abs()
    Bm = 0.5 * torch.randn((1, L, s.d_state), generator=gen, device=device)
    Cm = 0.5 * torch.randn((1, L, s.d_state), generator=gen, device=device)
    (y, S), secs = timed(lambda: mamba2.ssd_chunked(xdt, dtA, Bm, Cm,
                                                    s.chunk))
    yn, Sn = mamba2.naive_ssd(xdt, dtA, Bm, Cm)
    y64, S64 = mamba2.naive_ssd(*(t.double() for t in (xdt, dtA, Bm, Cm)))
    err = max(float((y - yn).abs().max()), float((S - Sn).abs().max()))
    out = {"chunked_vs_naive": err,
           "chunked_vs_f64": float((y.double() - y64).abs().max()),
           "naive_vs_f64": float((yn.double() - y64).abs().max()),
           "chunked_ms": secs * 1e3}
    gates.check("mamba2 ssd_chunked == naive_ssd", err <= SSD_TOL,
                f"B=1, L={L}, H={H}, P={s.head_dim}, N={s.d_state}, chunk "
                f"{s.chunk}, f32: max abs err {err:.2e} (tol {SSD_TOL:.0e}); "
                f"against the f64 recurrence: chunked "
                f"{out['chunked_vs_f64']:.2e}, naive {out['naive_vs_f64']:.2e}"
                f"; chunked scan {out['chunked_ms']:.2f} ms (host clock)")
    return out


def decode_bound_ms(cfg, cache_bytes: int) -> tuple:
    """The least time of one decode step: every weight it reads, read once
    (the MoE decode runs every expert on its capacity buffer; the encoder
    and, when the embeddings are untied, the embedding table are not read
    but for a row a slot), and the cache it reads, at the card's memory
    rate.  Returns (ms, weight bytes)."""
    from repro_torch.models import api
    from repro_torch.models.module import param_bytes
    specs = api.param_specs(cfg)
    skip = {"encoder", "enc_norm"} | (
        set() if cfg.tie_embeddings else {"embedding"})
    weights = param_bytes({k: v for k, v in specs.items() if k not in skip})
    return (weights + cache_bytes) / HBM_BYTES_PER_S * 1e3, weights


def cache_read_bytes(cache, cfg, pos: int) -> int:
    """Bytes of the decode cache one step reads: every mamba state (read
    and written), and attention k / v rows up to ``pos``; cross k / v
    whole."""
    total = 0

    def walk(tree, name=""):
        nonlocal total
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k)
        elif name in ("k", "v"):
            total += tree[:, :, :pos + 1].numel() * tree.element_size()
        elif name == "ssm":
            total += 2 * tree.numel() * tree.element_size()
        else:
            total += tree.numel() * tree.element_size()
    walk(cache)
    return total


def family_serving(tag: str, cfg, model, prompts, new: int, slots: int,
                   max_seq: int) -> dict:
    """bf16 serving through the engine: prefill ms per prompt length,
    decode ms a step beside its bound, tok/s, the decode's device-idle
    share (profiler trace of 8 steps) and the allocator's peak."""
    from repro_torch.models import api
    from repro_torch.serve import Engine, ServeConfig
    eng = Engine(cfg, model, ServeConfig(max_seq=max_seq, slots=slots,
                                         min_bucket=32))
    eng.generate([prompts[0]], 2)                       # warm-up, not timed
    prefill_ms, decode_ms = {}, []
    inner_prefill, inner_decode = eng._prefill, eng._decode

    def timed_prefill(tokens):
        out, secs = timed(lambda: inner_prefill(tokens))
        prefill_ms.setdefault(tokens.shape[1], []).append(secs * 1e3)
        return out

    def timed_decode(tok, pos):
        out, secs = timed(lambda: inner_decode(tok, pos))
        decode_ms.append(secs * 1e3)
        return out

    eng._prefill, eng._decode = timed_prefill, timed_decode
    torch.cuda.reset_peak_memory_stats()
    outs, secs = timed(lambda: eng.generate(prompts, new))
    peak = torch.cuda.max_memory_allocated()
    del eng._prefill, eng._decode           # the cycle (as in lm_serving)
    ntok = sum(len(o) for o in outs)
    if [len(o) for o in outs] != [new] * len(prompts):
        raise AssertionError(f"{tag} serving: token counts "
                             f"{[len(o) for o in outs]}")
    pos = max(len(p) for p in prompts) + new // 2
    bound, weights = decode_bound_ms(cfg, cache_read_bytes(eng.cache, cfg,
                                                           pos))
    steady = sorted(decode_ms)[len(decode_ms) // 2]
    log(f"  {tag} serving (bf16, {cfg.n_layers} layers, weights "
        f"{weights / 1e9:.3f} GB): {len(prompts)} requests (prompts "
        f"{[len(p) for p in prompts]}) x {new} tokens through {slots} slots "
        f"in {secs:.3f} s: {ntok / secs:.1f} tok/s aggregate; "
        f"{len(decode_ms)} decode steps")
    for length, ms in sorted(prefill_ms.items()):
        log(f"    prefill of {length:4d} tokens: {len(ms)} calls, ms "
            + ", ".join(f"{t:.2f}" for t in ms))
    log(f"    decode ms a step (all {slots} slots, host clock to a "
        f"synchronise): median {steady:.3f}, min {min(decode_ms):.3f}, max "
        f"{max(decode_ms):.3f}; weight- and state-read bound {bound:.3f} ms "
        f"(median / bound {steady / bound:.2f}); peak allocated "
        f"{peak / 2**30:.2f} GiB")
    tok = torch.ones((slots,), dtype=torch.long, device=model.device)
    posv = torch.full((slots,), pos, device=model.device)
    cache = api.init_cache(cfg, slots, max_seq, model.device)
    prof = profile_run(lambda: [api.decode_step(model, cfg, cache, tok, posv)
                                for _ in range(8)],
                       f"{tag} decode, 8 steps of {slots} slots (bf16)", 6)
    return {"prefill_ms": prefill_ms, "decode_ms_median": steady,
            "decode_ms_min": min(decode_ms), "bound_ms": bound,
            "weights_bytes": weights, "tok_s": ntok / secs, "wall_s": secs,
            "peak_bytes": peak, "idle": prof["idle"],
            "decode_profile": prof}


def mamba_phase(gates, seed: int, stats: dict, dev) -> None:
    """12a: mamba2-370m at its published width and depth."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = dataclasses.replace(get_config("mamba2_370m"), dtype=torch.float32,
                              param_dtype=torch.float32)
    model, secs = timed(lambda: api.init_model(cfg, gen))
    log(f"  12a {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{sum(p.numel() for p in model.parameters())} parameters, "
        f"initialised in {secs:.2f} s")
    rec = {"ssd": gate_ssd(gates, cfg, dev, gen)}
    rec["f32"] = gate_prefill_decode(gates, "mamba2 f32", cfg, model,
                                     family_batch(cfg, dev, gen, S=256))
    chunk = cfg.ssm.chunk
    gate_engine(gates, "mamba2 f32", cfg, model,
                ssm_prompts(cfg.vocab, (chunk, 2 * chunk), seed))
    model64 = model.cast(torch.float64)
    rec["f64"] = gate_prefill_decode(gates, "mamba2 f64", model64.cfg,
                                     model64, family_batch(cfg, dev, gen,
                                                           S=256))
    gate_engine(gates, "mamba2 f64", model64.cfg, model64,
                ssm_prompts(cfg.vocab, (chunk, 2 * chunk), seed + 1))
    del model64
    model16 = model.cast(torch.bfloat16)
    del model
    torch.cuda.empty_cache()
    lg, _ = api.prefill(model16, model16.cfg,
                        family_batch(cfg, dev, gen, B=1, S=256))
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("mamba2 bf16 prefill logits are not finite")
    rec["serve"] = family_serving(
        "12a mamba2-370m", model16.cfg, model16,
        ssm_prompts(cfg.vocab, SSM_PROMPTS, seed + 2), FAMILY_SERVE_NEW,
        SERVE_SLOTS, 1024)
    stats["lm_mamba2"] = rec
    del model16
    torch.cuda.empty_cache()


def moe_metrics(cfg, model, batch) -> dict:
    from repro_torch.models import api
    _, aux = api.forward(model, cfg, batch)
    return {k: float(v) for k, v in aux.items()}


def moe_phase(gates, seed: int, stats: dict, dev) -> None:
    """12b: phi3.5-moe-42b at its published width: gates at
    MOE_GATE_LAYERS layers in f32 and f64, bf16 serving at
    MOE_SERVE_LAYERS."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    gen = torch.Generator(device=dev).manual_seed(seed)
    full = get_config("phi3_5_moe_42b")
    published = dataclasses.replace(full, n_layers=MOE_GATE_LAYERS,
                                    dtype=torch.float32,
                                    param_dtype=torch.float32)
    # the gates at the reference's no-drop capacity (its reduced configs'
    # 4.0): a dropped slot depends on how many tokens share the dispatch,
    # so prefill + decode equals forward only without drops
    cfg = dataclasses.replace(published, moe=dataclasses.replace(
        published.moe, capacity_factor=MOE_GATE_CAPACITY))
    model = api.init_model(cfg, gen)
    rec = {}
    batch = family_batch(cfg, dev, gen)
    rec["f32"] = gate_prefill_decode(gates, "phi3.5-moe f32", cfg, model,
                                     batch)
    rec["f32_metrics"] = moe_metrics(cfg, model, batch)
    gate_engine(gates, "phi3.5-moe f32", cfg, model,
                serve_prompts(cfg.vocab, 13)[:2], max_seq=256)
    model64 = model.cast(torch.float64)
    rec["f64"] = gate_prefill_decode(gates, "phi3.5-moe f64", model64.cfg,
                                     model64, batch)
    rec["f64_metrics"] = moe_metrics(model64.cfg, model64, batch)
    rec["published_metrics"] = moe_metrics(published, model, batch)
    log(f"    MoE metrics at {cfg.n_layers} layers (B x S = 2 x 64), summed "
        f"over layers: capacity {cfg.moe.capacity_factor}: f32 "
        f"{rec['f32_metrics']}, f64 {rec['f64_metrics']}; the published "
        f"capacity {published.moe.capacity_factor}: "
        f"{rec['published_metrics']}")
    gates.check("phi3.5-moe f64 routing == f32 routing",
                rec["f32_metrics"]["moe_drop_frac"]
                == rec["f64_metrics"]["moe_drop_frac"],
                "the same drop fraction from the same tokens")
    del model, model64
    torch.cuda.empty_cache()
    cfg16 = dataclasses.replace(full, n_layers=MOE_SERVE_LAYERS)
    model16, secs = timed(lambda: api.init_model(cfg16, gen))
    log(f"  12b {cfg16.name} at {cfg16.n_layers} of {full.n_layers} layers: "
        f"{sum(p.numel() for p in model16.parameters())} parameters, bf16 "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"initialised in {secs:.2f} s")
    big = family_batch(cfg16, dev, gen, B=2, S=256)
    rec["bf16_metrics"] = moe_metrics(cfg16, model16, big)
    log(f"    MoE metrics, bf16, B x S = 2 x 256: {rec['bf16_metrics']}")
    rec["serve"] = family_serving("12b phi3.5-moe", cfg16, model16,
                                  serve_prompts(cfg16.vocab, 11),
                                  FAMILY_SERVE_NEW, SERVE_SLOTS,
                                  SERVE_MAX_SEQ)
    stats["lm_phi35_moe"] = rec
    del model16
    torch.cuda.empty_cache()


def greedy_decode_loop(cfg, model, batch, new: int) -> tuple:
    """Prefill, then ``new`` greedy decode_step calls on every row; the
    tokens (rows, new) and the ms of each step."""
    from repro_torch.models import api
    B, S = batch["tokens"].shape
    logits, cache = api.prefill(model, cfg, batch, max_seq=S + new)
    toks, ms = [], []
    tok = torch.argmax(logits[:, :cfg.vocab], dim=-1)
    for i in range(new):
        toks.append(tok)
        (logits, cache), secs = timed(lambda: api.decode_step(
            model, cfg, cache, tok, torch.full((B,), S + i,
                                               device=model.device)))
        ms.append(secs * 1e3)
        tok = torch.argmax(logits[:, :cfg.vocab], dim=-1)
    return torch.stack(toks, dim=1).tolist(), ms


def gate_greedy_loop(gates, tag: str, cfg, model, batch) -> None:
    """A greedy loop of decode_step against the step-by-step greedy
    forward (the encoder-decoder's serving path), row by row.  The oracle
    runs on the whole batch, so that its encoder sees the loop's inputs in
    the same shapes: through 24 random encoder layers and 24 decoder layers
    even f64's rounding of another batch shape grows to a top-2 margin."""
    from repro_torch.models import api
    outs, _ = greedy_decode_loop(cfg, model, batch, ORACLE_NEW)
    toks, lasts = batch["tokens"], []
    for _ in range(ORACLE_NEW):
        logits, _ = api.forward(model, cfg, dict(batch, tokens=toks))
        lasts.append(logits[:, -1, :cfg.vocab])
        toks = torch.cat([toks, torch.argmax(lasts[-1], dim=-1,
                                             keepdim=True).to(toks.dtype)],
                         dim=1)
    S = batch["tokens"].shape[1]
    for row in range(len(outs)):
        tokens_agree(gates, f"{tag} greedy decode_step loop row {row} == "
                     f"greedy oracle", outs[row], toks[row, S:].tolist(),
                     [last[row] for last in lasts])


def seamless_phase(gates, seed: int, stats: dict, dev) -> None:
    """12c: seamless-m4t-large-v2 at its published width and depth."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    gen = torch.Generator(device=dev).manual_seed(seed)
    full = dataclasses.replace(get_config("seamless_m4t_large_v2"),
                               dtype=torch.float32, param_dtype=torch.float32)
    cut = dataclasses.replace(full, n_layers=SEAMLESS_F32_LAYERS,
                              enc_layers=SEAMLESS_F32_LAYERS)
    rec = {}
    model = api.init_model(cut, gen)
    batch = family_batch(cut, dev, gen)
    rec["f32_cut"] = gate_prefill_decode(gates, "seamless f32", cut, model,
                                         batch)
    gate_greedy_loop(gates, "seamless f32", cut, model, batch)
    del model
    model, secs = timed(lambda: api.init_model(full, gen))
    log(f"  12c {full.name}: {full.enc_layers} + {full.n_layers} layers, "
        f"{sum(p.numel() for p in model.parameters())} parameters, "
        f"initialised in {secs:.2f} s")
    model64 = model.cast(torch.float64)
    batch = family_batch(full, dev, gen)
    rec["f64"] = gate_prefill_decode(gates, "seamless f64", model64.cfg,
                                     model64, batch)
    gate_greedy_loop(gates, "seamless f64", model64.cfg, model64, batch)
    full32 = prefill_decode(full, model, batch)[0]
    full64 = prefill_decode(model64.cfg, model64, batch)[0]
    rec["f32_vs_f64_full_depth"] = float((full32 - full64).abs().max()) / \
        float(full64.abs().max())
    log(f"    seamless f32 forward against f64 at full depth (reported): "
        f"{rec['f32_vs_f64_full_depth']:.3e} of the largest logit")
    del model64
    model16 = model.cast(torch.bfloat16)
    del model
    torch.cuda.empty_cache()
    cfg16 = model16.cfg
    slots, S = SERVE_SLOTS, 256
    batch = family_batch(cfg16, dev, gen, B=slots, S=S)
    torch.cuda.reset_peak_memory_stats()
    (outs, ms), secs = timed(lambda: greedy_decode_loop(
        cfg16, model16, batch, FAMILY_SERVE_NEW))
    peak = torch.cuda.max_memory_allocated()
    _, cache = api.prefill(model16, cfg16, batch, max_seq=S + 32)
    bound, weights = decode_bound_ms(cfg16, cache_read_bytes(cache, cfg16,
                                                             S + 16))
    steady = sorted(ms)[len(ms) // 2]
    ntok = slots * FAMILY_SERVE_NEW
    log(f"  12c seamless serving (bf16, {cfg16.enc_layers} + "
        f"{cfg16.n_layers} layers, weights {weights / 1e9:.3f} GB): prefill "
        f"of {slots} x {S} tokens with {S // 4} frames, then "
        f"{FAMILY_SERVE_NEW} greedy decode_step calls in {secs:.3f} s: "
        f"{ntok / secs:.1f} tok/s; decode ms a step median {steady:.3f}, "
        f"min {min(ms):.3f}; weight- and cache-read bound {bound:.3f} ms "
        f"(median / bound {steady / bound:.2f}); peak allocated "
        f"{peak / 2**30:.2f} GiB")
    tok = torch.ones((slots,), dtype=torch.long, device=dev)
    pos = torch.full((slots,), S + 16, device=dev)
    prof = profile_run(lambda: [api.decode_step(model16, cfg16, cache, tok,
                                                pos) for _ in range(8)],
                       f"12c seamless decode, 8 steps of {slots} rows "
                       f"(bf16)", 6)
    rec["serve"] = {"decode_ms_median": steady, "bound_ms": bound,
                    "weights_bytes": weights, "tok_s": ntok / secs,
                    "wall_s": secs, "peak_bytes": peak, "idle": prof["idle"],
                    "decode_profile": prof}
    stats["lm_seamless"] = rec
    del model16, cache
    torch.cuda.empty_cache()


def jamba_phase(gates, seed: int, stats: dict, dev) -> None:
    """12d: jamba-1.5-large's hybrid interleave at its reduced() widths
    (one superblock of 8 layers is 88 GB at the published width)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import api
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = dataclasses.replace(get_reduced("jamba_1_5_large_398b"),
                              dtype=torch.float32, param_dtype=torch.float32)
    model = api.init_model(cfg, gen)
    batch = family_batch(cfg, dev, gen)
    rec = {"f32": gate_prefill_decode(gates, "jamba (reduced) f32", cfg,
                                      model, batch),
           "metrics": moe_metrics(cfg, model, batch)}
    chunk = cfg.ssm.chunk
    gate_engine(gates, "jamba (reduced) f32", cfg, model,
                ssm_prompts(cfg.vocab, (chunk, 2 * chunk), seed))
    model64 = model.cast(torch.float64)
    rec["f64"] = gate_prefill_decode(gates, "jamba (reduced) f64",
                                     model64.cfg, model64, batch)
    gate_engine(gates, "jamba (reduced) f64", model64.cfg, model64,
                ssm_prompts(cfg.vocab, (chunk, 2 * chunk), seed + 1))
    log(f"    jamba (reduced) MoE metrics: {rec['metrics']}")
    stats["lm_jamba_reduced"] = rec


def families_phase(seed: int, stats: dict, dev=None) -> dict:
    """Phase 12: the ssm, moe, encoder-decoder and hybrid bodies on ``dev``
    (the card).  Plain torch, as in the reference (no TPU kernel on this
    path): the returned launch counts are all zero.  Raises at the end if
    any gate failed."""
    dev = torch.device("cuda") if dev is None else dev
    gates = Gates()
    gk.reset_launch_counts()
    for name, fn in (("12a", mamba_phase), ("12b", moe_phase),
                     ("12c", seamless_phase), ("12d", jamba_phase)):
        _, secs = timed(lambda: fn(gates, seed, stats, dev))
        stats[f"phase{name}_s"] = secs
        log(f"  {name} took {secs:.1f} s")
    counts = launches()
    if gates.failed:
        raise AssertionError(f"phase 12 gates failed: {gates.failed}")
    return counts


# Phase 13: training, random weights from --seed.  (a) / (b) llama3.2-3b at
# its published width cut to TRAIN_EXACT_LAYERS layers, in f64 (the layers
# compute in f64 for f64 inputs), B = 2, S = 64, the same weights on the
# card and on the CPU: loss_fn's gradient tree against the CPU's (each leaf's
# relative Frobenius error; the two devices sum in other orders, f64
# rounding: expected about 1e-13), and central finite differences of the
# loss along a random direction (each leaf's entries N(0, 1) times its
# RMS) at h = FD_STEP and h / 2, extrapolated so that the h^2 term cancels
# (the random init's sharp softmax makes that term 1e-4 at h = 1e-6 and
# d_model 1024 on the CPU; the extrapolated difference reads 1e-10 there,
# and f64 rounding's eps / h about 1e-9); then one
# make_train_step step on both devices: the master, m and v are f32, and
# f64 gradients 1e-13 apart cast to the same f32 value or one ulp apart,
# so the gate is f32's: 1e-5 of each leaf's norm.  (c) and (d) draw the
# weights as init_params does and then rescale the attention projections to
# the fan-in of their contraction (attention_fan_in): under the reference's
# own init the gradient grows about 8x a layer, so at 28 layers the f32 sum
# of its squares overflows (grad_norm inf on the card in both packages'
# arithmetic, and the clip then zeroes every update), and at 8 layers in
# f32 one microbatch's gradient sat 10 % from two's.  (c) the full config
# (28 layers, bf16 weights, f32 master, remat "full", microbatches 1) at
# TRAIN_FULL_BATCH (4096 tokens a step), TRAIN_WARM steps then TRAIN_TIMED
# timed ones through Trainer.run on the TokenStream; the AdamW update timed
# by CUDA events inside the steps; the device-idle share of a traced step
# (two until phase 18 came: its seconds are taken back here).  No
# checkpoint of this state (about 45 GB of host memory).  (d)
# microbatches 2 against 1 on the same global batch, f32, at ACCUM_LAYERS
# layers (two f32 states, the f32 accumulators and the gradients of the
# full depth do not fit the card): the gradient of the mean of two
# halves' means is the full batch's up to f32 rounding, so grad_norm at
# 1e-5, m and v at 1e-4 of each leaf's norm, and each leaf's move (master
# after - before) at 2e-3: Adam's first step moves an element by about lr
# sign(g), so an element whose gradient is within rounding of 0 can step
# the other way.  (e) the cpu-small preset (the reference's init) for its
# 200 steps through launch/train.py's main: the mean logged loss of its last
# 50 steps lies LEARN_MARGIN below that of its first 20 (the CPU run of the
# same preset: 11.0484 -> 10.8996, 0.1488); then exact resume (4 steps
# against 2, a checkpoint, a new Trainer and 2 more) under torch.equal, in
# deterministic mode (torch.use_deterministic_algorithms and
# CUBLAS_WORKSPACE_CONFIG, for these runs only: the backward of the
# embedding gather and of take_along_dim adds with atomics otherwise).  (f)
# granite-3-2b reduced, as the reference's elastic check (bf16), then in
# f32: 2 steps on ELASTIC_RANKS[0] gloo ranks sharing the card with a
# checkpoint, a restore on ELASTIC_RANKS[1] of them to step 4, against one
# rank on the same stream; the replicas the same bytes on every rank; the
# same restart of phi3.5-moe reduced in f32 with its experts sharded over
# the ranks (the replicated leaves the same bytes, TOL_ELASTIC["f32"]), and
# an MoE config refused on 3 ranks (E = 4 does not split).  TOL_ELASTIC:
# (loss atol, each leaf's
# f32 master move against its norm).  In bf16, P ranks sum P bf16
# gradients where one rank rounds one, and Adam's normalised step turns a
# gradient element within rounding of 0 into a move of lr either way: on
# the CPU (seeds 0-2, 4 -> 2 and 2 -> 1 ranks) up to 3.4e-3 and 5.2e-2; in
# f32 up to 9.5e-7 and 1.8e-5.
TRAIN_EXACT_LAYERS = 2
TRAIN_EXACT_BATCH = (2, 64)
TOL_TRAIN_GRAD_F64 = 1e-10
TOL_TRAIN_FD = 1e-6
FD_STEP = 1e-6
TOL_TRAIN_STEP_F32 = 1e-5
TRAIN_FULL_BATCH = (2, 2048)
TRAIN_WARM, TRAIN_TIMED = 2, 5
ACCUM_LAYERS = 8
TOL_ACCUM_NORM = 1e-5
TOL_ACCUM_MOMENT = 1e-4
TOL_ACCUM_MOVE = 2e-3
LEARN_MARGIN = 0.1
ELASTIC_RANKS = (4, 2)
TOL_ELASTIC = {"bf16": (1e-2, 0.15), "f32": (1e-5, 2e-4)}


def tree_items(tree, path=()):
    """(path, leaf) of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def worst_leaf(got, want, base=None) -> tuple:
    """The largest relative Frobenius error over the leaves of ``got``
    against ``want`` (of the moves from ``base`` when given), with its
    leaf."""
    w = dict(tree_items(want))
    b = dict(tree_items(base)) if base is not None else {}
    errs = []
    for k, g in tree_items(got):
        t = w[k].to(g.device)
        if k in b:
            errs.append((rel(g - b[k], t - b[k]), k))
        else:
            errs.append((rel(g, t), k))
    return max(errs)


def attention_fan_in(params: dict, cfg) -> None:
    """Rescale, in place, the projections of every attention (decoder,
    encoder, cross) of a parameter tree
    drawn by ``init_params`` to the fan-in of their contraction: the
    reference's init divides by the axis before last, the heads for wq /
    wk / wv (24 or 8, not d_model 3072) and head_dim for wo (128, not
    heads x head_dim), which makes llama3.2-3b's scores about 200 wide and
    its gradient grow about 8x a layer (PERF.md, PR 23)."""
    for a in attention_trees(params):
        for k in ("wq", "wk", "wv"):
            a[k].mul_(math.sqrt(a[k].shape[-2] / cfg.d_model))
        a["wo"].mul_(1 / math.sqrt(a["wo"].shape[-3]))


def attention_trees(tree: dict):
    """Every attention's leaves (``attn`` / ``cross``) in a parameter
    tree."""
    for k, v in tree.items():
        if k in ("attn", "cross"):
            yield v
        elif isinstance(v, dict):
            yield from attention_trees(v)


def clone_tree(tree):
    return {k: clone_tree(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.clone()


def on_device(tree, device):
    """A copy of a tree of tensors or arrays on ``device``."""
    return {k: on_device(v, device) for k, v in tree.items()} \
        if isinstance(tree, dict) else torch.as_tensor(tree).to(device,
                                                               copy=True)


def train_exactness(cfg, gates, gen, dev, stats) -> None:
    """13a / 13b: loss_fn's gradients and one train step of the f64 model
    cut to TRAIN_EXACT_LAYERS layers, card against CPU; the finite
    difference on the card."""
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.models import api
    from repro_torch.models.module import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    cut = dataclasses.replace(cfg, n_layers=TRAIN_EXACT_LAYERS,
                              dtype=torch.float64, param_dtype=torch.float64)
    B, S = TRAIN_EXACT_BATCH
    params = init_params(api.param_specs(cut), gen)
    host = on_device(params, "cpu")
    batch = synthetic_lm_batch(cut.vocab, S, B, seed=1)
    batch["mask"][1, S // 2:] = 0.0                     # a masked tail

    def grads(p, device):
        model = api.build_model(cut, p).trainable()
        total, _ = api.loss_fn(model, cut, on_device(batch, device))
        total.backward()
        return float(total.detach()), model.grad_tree()

    (loss_card, g_card), secs_card = timed(lambda: grads(params, dev))
    t0 = time.perf_counter()
    loss_cpu, g_cpu = grads(host, torch.device("cpu"))
    secs_cpu = time.perf_counter() - t0
    err, leaf = worst_leaf(g_card, g_cpu)
    rec = {"layers": TRAIN_EXACT_LAYERS, "batch": [B, S],
           "loss_card": loss_card, "loss_cpu": loss_cpu, "grad_err": err,
           "grad_err_leaf": leaf, "card_s": secs_card, "cpu_s": secs_cpu}
    log(f"  13a {cut.name} at {TRAIN_EXACT_LAYERS} layers, f64, B = {B}, "
        f"S = {S}: loss card {loss_card:.17g}, CPU {loss_cpu:.17g}; "
        f"backward {secs_card:.2f} s on the card, {secs_cpu:.2f} s on the "
        f"CPU")
    gates.check("13a gradients, card against CPU",
                err <= TOL_TRAIN_GRAD_F64
                and abs(loss_card - loss_cpu) <= TOL_TRAIN_GRAD_F64 * loss_cpu,
                f"worst leaf {leaf} {err:.2e}, loss {abs(loss_card - loss_cpu):.2e}"
                f" (tol {TOL_TRAIN_GRAD_F64:.0e})")
    del g_cpu
    # the directional derivative against a central finite difference
    u = {k: torch.randn(t.shape, generator=gen, dtype=t.dtype,
                        device=t.device) * t.square().mean().sqrt()
         for k, t in tree_items(params)}
    deriv = sum(float((g * u[k]).sum()) for k, g in tree_items(g_card))
    del g_card

    def loss_at(h):
        shifted = {}
        for k, t in tree_items(params):
            node = shifted
            *head, last = k.split("/")
            for name in head:
                node = node.setdefault(name, {})
            node[last] = t + h * u[k]
        with torch.no_grad():
            return float(api.loss_fn(api.build_model(cut, shifted), cut,
                                     on_device(batch, dev))[0])

    h = FD_STEP
    central = [(loss_at(t) - loss_at(-t)) / (2 * t) for t in (h, h / 2)]
    fd = (4 * central[1] - central[0]) / 3          # the h^2 term cancels
    fd_err = abs(fd - deriv) / abs(deriv)
    rec.update(fd=fd, deriv=deriv, fd_err=fd_err, central=central)
    gates.check("13a finite difference", fd_err <= TOL_TRAIN_FD,
                f"<g, u> {deriv:.12g}, central differences at h = {h:.0e} "
                f"and h / 2 {central[0]:.12g}, {central[1]:.12g} (rel "
                + ", ".join(f"{abs(c - deriv) / abs(deriv):.2e}"
                            for c in central)
                + f"), extrapolated {fd:.12g}, rel {fd_err:.2e} "
                f"(tol {TOL_TRAIN_FD:.0e})")
    del u
    # one train step on both devices
    step = make_train_step(cut, AdamWConfig(lr=1e-3))
    states = {}
    for name, p, d in (("card", params, dev), ("cpu", host, "cpu")):
        st = {"params": p, "opt": init_opt_state(p),
              "step": torch.zeros((), dtype=torch.int32, device=d)}
        states[name], m = step(st, batch)
        rec[f"step_loss_{name}"] = float(m["loss"])
        rec[f"step_gnorm_{name}"] = float(m["grad_norm"])
    errs = {part: worst_leaf(states["card"][a][b] if b else
                             states["card"][a],
                             states["cpu"][a][b] if b else states["cpu"][a])
            for part, (a, b) in {"params": ("params", None),
                                 "master": ("opt", "master"),
                                 "m": ("opt", "m"),
                                 "v": ("opt", "v")}.items()}
    rec["step_err"] = {k: list(v) for k, v in errs.items()}
    worst = max(e for e, _ in errs.values())
    gates.check("13b one train step, card against CPU",
                worst <= TOL_TRAIN_STEP_F32
                and int(states["card"]["step"]) == 1,
                ", ".join(f"{k} {e:.2e} ({leaf})" for k, (e, leaf)
                          in errs.items())
                + f"; grad_norm card {rec['step_gnorm_card']:.9g}, CPU "
                f"{rec['step_gnorm_cpu']:.9g} (tol {TOL_TRAIN_STEP_F32:.0e})")
    stats["train_exact"] = rec


def train_full_width(cfg, gates, dev, stats) -> None:
    """13c: the full config's steps: ms a step, tok/s, the model-FLOP
    share, the AdamW update's ms, the allocator's peak, the idle share."""
    import repro_torch.train.trainer as trainer_mod
    from repro_torch.configs import n_params
    from repro_torch.train import Trainer, TrainRunConfig
    B, S = TRAIN_FULL_BATCH
    rc = TrainRunConfig(steps=TRAIN_WARM + TRAIN_TIMED, global_batch=B,
                        seq_len=S, lr=3e-4, warmup=1, log_every=1)
    torch.cuda.reset_peak_memory_stats()
    tr, secs = timed(lambda: Trainer(cfg, rc, device=dev))
    attention_fan_in(tr.state["params"], cfg)
    for (_, m), (_, p) in zip(tree_items(tr.state["opt"]["master"]),
                              tree_items(tr.state["params"])):
        m.copy_(p)                      # the master starts from the params
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_items(tr.state))
    init_peak = torch.cuda.max_memory_allocated()
    probes = {k: t.reshape(-1)[:4096].clone()
              for k, t in tree_items(tr.state)}
    log(f"  13c {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}, remat {cfg.remat!r}, params "
        f"{str(cfg.param_dtype).split('.')[-1]}; state {state_bytes / 1e9:.2f}"
        f" GB (params, f32 master, m, v), initialised in {secs:.1f} s, peak "
        f"{init_peak / 2**30:.2f} GiB")
    events = []
    inner = trainer_mod.adamw_update

    def timed_adamw(*args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        out = inner(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    trainer_mod.adamw_update = timed_adamw
    try:
        warm = tr.run(TRAIN_WARM)
        torch.cuda.reset_peak_memory_stats()
        hist = tr.run(TRAIN_WARM + TRAIN_TIMED)
        peak = torch.cuda.max_memory_allocated()
    finally:
        trainer_mod.adamw_update = inner
    torch.cuda.synchronize()
    adam_ms = [s.elapsed_time(e) for s, e in events[TRAIN_WARM:]]
    walls = [h["wall"] for h in hist]
    step_ms = [1e3 * (b - a) for a, b in zip([0.0] + walls, walls)]
    med = sorted(step_ms)[len(step_ms) // 2]
    tokens = B * S
    n = n_params(cfg)
    mfu = 6 * n * tokens / (med / 1e3) / FLOPS_PER_S["torch.bfloat16"]
    log(f"    warm-up losses {[round(h['loss'], 4) for h in warm]}; timed "
        f"steps (ms, host clock to the step's metrics): "
        + ", ".join(f"{t:.1f}" for t in step_ms)
        + f"; median {med:.1f} ms, {tokens / (med / 1e3):.0f} tok/s; "
        f"6 N tokens ({n} parameters) at the bf16 dense rate: "
        f"{mfu:.1%} (the recompute and the attention scores not counted)")
    log(f"    AdamW update (CUDA events) ms: "
        + ", ".join(f"{t:.1f}" for t in adam_ms)
        + f"; losses {[round(h['loss'], 4) for h in hist]}, grad norms "
        f"{[round(h['grad_norm'], 3) for h in hist]}")
    log(f"    peak allocated over the timed steps {peak / 2**30:.2f} GiB "
        f"({peak / 1e9:.2f} GB against {state_bytes / 1e9:.2f} GB of state;"
        f" card {torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}"
        " GiB)")
    prof = profile_run(lambda: tr.run(int(tr.state["step"]) + 1),
                       "13c one training step", 8)
    # every f32 master leaf moves (weight decay reaches the norms too);
    # a bf16 norm of ones can round back to 1 in a few steps
    moved = {part: sum(not torch.equal(t.reshape(-1)[:4096], probes[k])
                       for k, t in tree_items(tr.state) if k.startswith(part))
             for part in ("params/", "opt/master/")}
    leaves = sum(k.startswith("params/") for k in probes)
    every = warm + hist
    finite = all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                 for h in every)
    total = torch.cuda.get_device_properties(0).total_memory
    final_step = int(tr.state["step"])
    gates.check("13c full-width steps",
                finite and final_step == TRAIN_WARM + TRAIN_TIMED + 2
                and moved["opt/master/"] == leaves and moved["params/"] > 0
                and peak < total,
                f"finite {finite}, step {final_step}, leaves moved: master "
                f"{moved['opt/master/']} of {leaves}, params "
                f"{moved['params/']}, peak {peak / 2**30:.2f} GiB")
    stats["train_full"] = {
        "batch": [B, S], "step_ms": step_ms, "step_ms_median": med,
        "tok_s": tokens / (med / 1e3), "mfu_6nt": mfu, "n_params": n,
        "adamw_ms": adam_ms, "peak_bytes": peak, "init_peak_bytes":
        init_peak, "state_bytes": state_bytes, "history": warm + hist,
        "profile": prof}
    del tr, probes
    torch.cuda.empty_cache()


def train_accumulation(cfg, gates, gen, dev, stats, seed: int) -> None:
    """13d: microbatches 2 against 1 on one global batch, f32, at
    ACCUM_LAYERS layers."""
    from repro_torch.data import TokenStream
    from repro_torch.models import api
    from repro_torch.models.module import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    cut = dataclasses.replace(cfg, n_layers=ACCUM_LAYERS,
                              dtype=torch.float32, param_dtype=torch.float32)
    B, S = TRAIN_FULL_BATCH
    params = init_params(api.param_specs(cut), gen)
    attention_fan_in(params, cut)
    start = clone_tree(params)          # the master before the step
    batch = TokenStream(cut.vocab, S, B, seed=seed).batch_at(0)
    out = {}
    for mb in (1, 2):
        p = clone_tree(params) if mb == 1 else params
        st = {"params": p, "opt": init_opt_state(p),
              "step": torch.zeros((), dtype=torch.int32, device=dev)}
        (st, m), secs = timed(lambda: make_train_step(
            cut, AdamWConfig(lr=3e-4), mb)(st, batch))
        out[mb] = (st, {k: float(v) for k, v in m.items()}, secs)
    (s1, m1, t1), (s2, m2, t2) = out[1], out[2]
    gn = abs(m2["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"]
    mom = max(worst_leaf(s2["opt"][k], s1["opt"][k]) for k in ("m", "v"))
    move = worst_leaf(s2["opt"]["master"], s1["opt"]["master"], start)
    log(f"  13d microbatches 2 against 1, f32, {ACCUM_LAYERS} layers, "
        f"B = {B}, S = {S}: step {t1 * 1e3:.0f} / {t2 * 1e3:.0f} ms; losses "
        f"(last microbatch's, as the reference reports) {m1['loss']:.6f} / "
        f"{m2['loss']:.6f}")
    gates.check("13d gradient accumulation",
                gn <= TOL_ACCUM_NORM and mom[0] <= TOL_ACCUM_MOMENT
                and move[0] <= TOL_ACCUM_MOVE,
                f"grad_norm {gn:.2e} (tol {TOL_ACCUM_NORM:.0e}), m / v "
                f"{mom[0]:.2e} at {mom[1]} (tol {TOL_ACCUM_MOMENT:.0e}), "
                f"master move {move[0]:.2e} at {move[1]} (tol "
                f"{TOL_ACCUM_MOVE:.0e})")
    stats["train_accum"] = {"layers": ACCUM_LAYERS, "grad_norm_err": gn,
                            "moment_err": list(mom), "move_err": list(move),
                            "ms": [t1 * 1e3, t2 * 1e3]}
    del out, s1, s2, params, start
    torch.cuda.empty_cache()


def train_learning(gates, dev, stats, seed: int) -> None:
    """13e: the cpu-small preset's 200 steps through launch/train.py's
    main, then exact resume in deterministic mode."""
    import os
    import tempfile

    from repro_torch.launch import train as launch_train
    from repro_torch.train import Trainer, TrainRunConfig
    hist, secs = timed(lambda: launch_train.main(
        ["--preset", "cpu-small", "--seed", str(seed), "--device",
         str(dev)]))
    first = [h["loss"] for h in hist if h["step"] <= 20]
    last = [h["loss"] for h in hist if h["step"] > hist[-1]["step"] - 50]
    drop = sum(first) / len(first) - sum(last) / len(last)
    log(f"  13e cpu-small: {hist[-1]['step']} steps in {secs:.1f} s "
        f"({1e3 * secs / hist[-1]['step']:.1f} ms a step), loss "
        f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    gates.check("13e learning", drop >= LEARN_MARGIN,
                f"the mean logged loss of the last 50 steps is {drop:.4f} "
                f"below that of the first 20 (gate {LEARN_MARGIN})")
    rec = {"losses": [[h["step"], h["loss"]] for h in hist], "s": secs,
           "drop": drop}
    preset = launch_train.PRESETS["cpu-small"]
    cfg = launch_train.build_model_cfg("qwen2_0_5b", preset)
    rc = TrainRunConfig(steps=4, global_batch=preset["global_batch"],
                        seq_len=preset["seq_len"], lr=preset["lr"],
                        seed=seed, save_every=2, log_every=1)
    saved_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        straight = Trainer(cfg, rc, device=dev)
        straight.run()
        with tempfile.TemporaryDirectory() as d:
            Trainer(cfg, dataclasses.replace(rc, steps=2, ckpt_dir=d),
                    device=dev).run()
            resumed = Trainer(cfg, dataclasses.replace(rc, ckpt_dir=d),
                              device=dev)
            at = int(resumed.state["step"])
            resumed.run()
        a, b = dict(tree_items(resumed.state)), dict(tree_items(
            straight.state))
        differ = [k for k in b if a[k].dtype != b[k].dtype
                  or not torch.equal(a[k], b[k])]
        ok = (not differ and at == 2 and resumed.stream.step ==
              straight.stream.step == 4)
        detail = (f"resumed at {at}, cursors {resumed.stream.step} / "
                  f"{straight.stream.step}, {len(b)} leaves, differing "
                  f"{differ[:4]}")
    except RuntimeError as e:                 # an op refusing the mode
        ok, detail = False, f"deterministic mode refused: {e}"
    finally:
        torch.use_deterministic_algorithms(False)
        if saved_env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved_env
    gates.check("13e exact resume (torch.equal, deterministic mode)", ok,
                detail)
    rec["resume"] = {"ok": ok, "detail": detail}
    stats["train_learning"] = rec


def elastic_case(world, cfg, rc, dev, ckpt_dir: str) -> dict:
    """One elastic restart of ``cfg`` on ``world``: 2 steps on
    ELASTIC_RANKS[0] ranks with a checkpoint, 2 more on ELASTIC_RANKS[1]
    after the restore, against one Trainer on the same stream."""
    from repro_torch.train import Trainer, run_data_parallel
    one = Trainer(cfg, rc, device=dev)
    hist_one = one.run()
    start = one._fresh_state()["opt"]["master"]
    first, second = ELASTIC_RANKS
    out_a = run_data_parallel(world, cfg, dataclasses.replace(
        rc, steps=2, ckpt_dir=ckpt_dir))
    out_b = run_data_parallel(world, cfg, dataclasses.replace(
        rc, ckpt_dir=ckpt_dir), n_ranks=second)
    hist = out_a["history"] + out_b["history"]
    state = on_device(out_b["state"], dev)
    return {"step": int(state["step"]), "steps": [h["step"] for h in hist],
            "loss": [h["loss"] for h in hist],
            "loss_one": [h["loss"] for h in hist_one],
            "loss_err": max(abs(x["loss"] - y["loss"])
                            for x, y in zip(hist, hist_one)),
            "move": list(worst_leaf(state["opt"]["master"],
                                    one.state["opt"]["master"], start)),
            "replicas": [len(out_a["digests"]), len(out_b["digests"])]}


def train_elastic(gates, dev, stats, world=None) -> None:
    """13f: the elastic restart of granite-3-2b reduced (bf16, as in the
    reference's check, then in f32) and of phi3.5-moe reduced in f32 (its
    four experts sharded over the ranks, one a rank, then two),
    ELASTIC_RANKS[0] -> ELASTIC_RANKS[1] gloo ranks sharing the card,
    against one rank; an MoE config refused on 3 ranks (E = 4).  On
    ``world`` when given (the world phases 13f-18 share: its caller
    closes it), else on a world of its own."""
    import contextlib
    import tempfile

    from repro_torch.configs import get_reduced
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainRunConfig, make_train_step
    bf16 = get_reduced("granite_3_2b")
    rc = TrainRunConfig(steps=4, global_batch=8, seq_len=32, lr=1e-3,
                        warmup=1, save_every=2, log_every=1)
    own = world is None
    secs = 0.0
    if own:
        world, secs = timed(lambda: spawn_world(dev, ELASTIC_RANKS[0]))
    rec = {"spawn_s": secs}
    with world if own else contextlib.nullcontext():
        for tag, cfg in (("bf16", bf16), ("f32", dataclasses.replace(
                bf16, dtype=torch.float32, param_dtype=torch.float32))):
            with tempfile.TemporaryDirectory() as d:
                rec[tag] = elastic_case(world, cfg, rc, dev, d)
        moe = get_reduced("phi3_5_moe_42b")
        moe = dataclasses.replace(moe, dtype=torch.float32,
                                  param_dtype=torch.float32,
                                  moe=dataclasses.replace(
                                      moe.moe, capacity_factor=1.25))
        with tempfile.TemporaryDirectory() as d:
            rec["moe f32"] = elastic_case(world, moe, rc, dev, d)

        class Three:
            size, rank = 3, 0
        try:
            make_train_step(moe, AdamWConfig(), comm=Three())
            rec["moe_split"] = "not refused"
        except ValueError as e:
            rec["moe_split"] = ("refused" if "E=4" in str(e)
                                else f"another error: {e}")
    log(f"  13f {bf16.name} on {ELASTIC_RANKS[0]} gloo ranks"
        + (f" spawned in {secs:.1f} s" if own else " (the shared world)"))
    for tag, (tol_loss, tol_move) in (*TOL_ELASTIC.items(),
                                      ("moe f32", TOL_ELASTIC["f32"])):
        r = rec[tag]
        log(f"    {tag}: losses {[round(x, 6) for x in r['loss']]} against "
            f"one rank's {[round(x, 6) for x in r['loss_one']]}")
        gates.check(f"13f elastic restart, {tag}",
                    r["step"] == 4 and r["steps"] == [1, 2, 3, 4]
                    and r["replicas"] == list(ELASTIC_RANKS)
                    and r["loss_err"] <= tol_loss
                    and r["move"][0] <= tol_move,
                    f"step {r['step']}, replicas the same bytes on "
                    f"{r['replicas']} ranks, loss {r['loss_err']:.2e} (tol "
                    f"{tol_loss:.0e}), master move {r['move'][0]:.2e} at "
                    f"{r['move'][1]} (tol {tol_move:g})")
    gates.check("13f MoE on 3 ranks (E = 4)", rec["moe_split"] == "refused",
                rec["moe_split"])
    stats["train_elastic"] = rec


def train_phase(seed: int, stats: dict, dev=None, world=None) -> dict:
    """Phase 13: training (plain torch, as in the reference: no TPU kernel
    on this path; the returned launch counts are all zero); 13f on
    ``world`` when given.  Raises at the end if any gate failed."""
    from repro_torch.configs import get_config
    dev = torch.device("cuda") if dev is None else dev
    gates = Gates()
    gk.reset_launch_counts()
    cfg = get_config("llama3_2_3b")
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, fn in (
            ("13ab", lambda: train_exactness(cfg, gates, gen, dev, stats)),
            ("13c", lambda: train_full_width(cfg, gates, dev, stats)),
            ("13d", lambda: train_accumulation(cfg, gates, gen, dev, stats,
                                               seed)),
            ("13e", lambda: train_learning(gates, dev, stats, seed)),
            ("13f", lambda: train_elastic(gates, dev, stats, world))):
        _, secs = timed(fn)
        stats[f"phase{name}_s"] = secs
        log(f"  {name} took {secs:.1f} s")
    counts = launches()
    if gates.failed:
        raise AssertionError(f"phase 13 gates failed: {gates.failed}")
    return counts


# ---------------------------------------------------------------------------
# Phase 14: the LM dry run and roofline on a world of ranks, flash-decoding
# over a sequence-sharded cache, the batched solver dry-run cells, lasso
# ---------------------------------------------------------------------------

SEQ_RANKS = 4                   # gloo ranks sharing the card
# llama3.2-3b's decode attention at decode_32k's length
FLASH = {"B": 4, "H": 24, "Hkv": 8, "Dh": 128, "S": 32768}
# a row in the first shard, one at the last key of shard 0 (every later
# shard wholly after it), one at the first key of shard 2, one at the end
FLASH_POS = (100, 8191, 16384, 32767)
# bf16: both sides sum in f32 and round the output to bf16 (2^-8 relative),
# so they may differ by an ulp of outputs of magnitude up to 1
FLASH_TOL = {"f32": 1e-5, "bf16": 1e-2}
SHARD_LAYERS, SHARD_PROMPT, SHARD_STEPS = 2, 63, 8
SHARD_MAX_SEQ = 128             # shards of 32: steps at 63..70 cross 64
DRYRUN_WORLD = (("llama3_2_3b", "train_4k"), ("llama3_2_3b", "decode_32k"),
                ("phi3_5_moe_42b", "train_4k"), ("dbrx_132b", "train_4k"),
                ("jamba_1_5_large_398b", "train_4k"))
DRYRUN_TENANTS = 8


def flash_decoding_check(world, gates, dev, seed: int, stats) -> None:
    """14a: decode_attention_seqsharded on SEQ_RANKS ranks against
    decode_attention on the whole cache, f32 and bf16: two all-reduces a
    call, under a quarter of the cache's bytes."""
    from repro_torch.launch.flash_decode import flash_decode
    from repro_torch.models import layers as L
    g = torch.Generator(device=dev).manual_seed(seed)
    B, H, Hkv, Dh, S = (FLASH[k] for k in ("B", "H", "Hkv", "Dh", "S"))
    q = torch.randn((B, 1, H, Dh), generator=g, device=dev)
    ck, cv = (torch.randn((B, S, Hkv, Dh), generator=g, device=dev)
              for _ in range(2))
    pos = torch.tensor(FLASH_POS, device=dev)
    rec = {}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        qq, kk, vv = (t.to(dtype) for t in (q, ck, cv))
        dense = L.decode_attention(qq, kk, vv, pos).float().cpu()
        got, secs = timed(lambda: flash_decode(world, qq, kk, vv, pos,
                                               SEQ_RANKS))
        err = float((got["out"].float() - dense).abs().max())
        cache_bytes = 2 * kk.numel() * kk.element_size()
        cs = got["counters"]
        rec[tag] = {"err": err, "all_reduces": [c["all_reduces"] for c in cs],
                    "max": [c["max_reduces"] for c in cs],
                    "bytes": cs[0]["bytes"], "cache_bytes": cache_bytes,
                    "reduce_ms": max(c["reduce_s"] for c in cs) * 1e3,
                    "call_s": secs}
        gates.check(
            f"14a flash-decoding {tag}",
            err <= FLASH_TOL[tag] and all(
                c["all_reduces"] == 2 and c["max_reduces"] == 1
                and c["bytes"] < cache_bytes / 4 for c in cs),
            f"max |flash - dense| {err:.3e} (tol {FLASH_TOL[tag]:g}); "
            f"all-reduces by rank {rec[tag]['all_reduces']} (max "
            f"{rec[tag]['max']}); {cs[0]['bytes']} bytes a rank against a "
            f"{cache_bytes}-byte cache; the slowest rank's host ms in its "
            f"all-reduces {rec[tag]['reduce_ms']:.3f}; pos {FLASH_POS}")
        del qq, kk, vv, got
    del q, ck, cv
    stats["flash_decoding"] = rec


def sharded_decode_check(world, gates, dev, seed: int, stats) -> None:
    """14b: llama3.2-3b at full width cut to SHARD_LAYERS layers, f32:
    prefill of SHARD_PROMPT tokens, then SHARD_STEPS greedy decode steps
    with the cache sequence-sharded over SEQ_RANKS ranks against the local
    decode_step on the whole cache."""
    from repro_torch.configs import get_config
    from repro_torch.launch.flash_decode import local_decode, sharded_decode
    from repro_torch.models import api
    from repro_torch.models.module import init_params
    cfg = dataclasses.replace(get_config("llama3_2_3b"),
                              n_layers=SHARD_LAYERS, dtype=torch.float32,
                              param_dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(api.param_specs(cfg), gen, dev)
    model = api.build_model(cfg, params)
    tokens = torch.randint(0, cfg.vocab, (2, SHARD_PROMPT), generator=gen,
                           device=dev)
    with torch.no_grad():
        logits, cache = api.prefill(model, cfg, {"tokens": tokens},
                                    max_seq=SHARD_MAX_SEQ)
    tok = logits[:, :cfg.vocab].argmax(-1)
    pos = torch.full((2,), SHARD_PROMPT, device=dev)
    whole = clone_tree(cache)
    local = local_decode(model, cfg, whole, tok, pos, SHARD_STEPS)
    got = sharded_decode(world, cfg, params, cache, tok, pos, SHARD_STEPS,
                         SEQ_RANKS)
    err = float((got["logits"] - local["logits"]).abs().max())
    want = [2 * SHARD_LAYERS] * SHARD_STEPS
    ms = float(np.median(got["step_s"][1:])) * 1e3
    local_ms = float(np.median(local["step_s"][1:])) * 1e3
    stats["sharded_decode"] = {"err": err, "step_ms": ms,
                               "local_step_ms": local_ms,
                               "all_reduces": got["all_reduces"]}
    gates.check("14b decode on the sharded cache",
                torch.equal(got["tokens"], local["tokens"]) and err <= LM_TOL
                and got["all_reduces"] == want,
                f"tokens {got['tokens'].T.tolist()} equal to the local "
                f"decode's: {torch.equal(got['tokens'], local['tokens'])}; "
                f"max |logits diff| {err:.3e} (tol {LM_TOL:g}); all-reduces "
                f"a step {got['all_reduces']} (2 x {SHARD_LAYERS} attention "
                f"layers); {ms:.2f} ms a step on {SEQ_RANKS} ranks (the "
                f"slowest rank, median of steps 2-{SHARD_STEPS}) against "
                f"{local_ms:.2f} ms local")
    del model, params, cache, whole


def dryrun_check(world, gates, dev, seed: int, stats) -> None:
    """14c: the dry run of every arch x applicable shape on one rank with
    the probe, and DRYRUN_WORLD's cells on SEQ_RANKS ranks; the roofline
    tables; failed == 0 and every skip with its reason."""
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch import dryrun, roofline
    out = Path(__file__).resolve().parent / "artifacts" / \
        "dryrun_chip_smoke"
    shutil.rmtree(out, ignore_errors=True)     # this run's records only
    out = str(out)
    results = dryrun.run(ARCH_IDS, list(SHAPES), 1, out, device=dev,
                         seed=seed)
    for arch, shape in DRYRUN_WORLD:
        results += dryrun.run([arch], [shape], SEQ_RANKS, out, device=dev,
                              world=world, seed=seed)
    cells = roofline.load_cells(out)
    for mesh in ("p1", f"p{SEQ_RANKS}"):
        log(f"  14c roofline, {mesh} (H100 SXM peaks: 989 TFLOP/s bf16, "
            f"3.35 TB/s, NVLink 450 GB/s):")
        for line in roofline.table(cells, mesh).splitlines():
            log(f"    {line}")
    count = dryrun.summarize(results)
    skips = [r for r in results if r["status"] == "skipped"] + [
        r["probe_record"] for r in results
        if (r.get("probe_record") or {}).get("status") == "skipped"]
    stats["dryrun"] = {"count": count, "records": [
        {"cell": list(key), **slots} for key, slots in sorted(cells.items())],
        "rows": [
        roofline.analyze_cell(a, s, m, slots["base"], slots.get("probe"))
        for (a, s, m), slots in sorted(cells.items()) if "base" in slots]}
    gates.check("14c dry run",
                count["failed"] == 0 and all(r.get("reason") for r in skips)
                and all("GB" in r["reason"] for r in skips
                        if "fit" in r["reason"]),
                f"{len(results)} cells: {count['ok']} ok "
                f"({count['probes_skipped']} without a probe), "
                f"{count['skipped']} skipped, {count['failed']} failed"
                + "".join(f"; FAILED {r['arch']} {r['shape']} {r['mesh']}: "
                          f"{r.get('error')}" for r in results
                          if r["status"] == "failed"))


def batched_dryrun_check(world, gates, dev, stats) -> None:
    """14d: ``solver_dryrun --tenants 8 --verify 4`` on the card."""
    from repro_torch.launch import solver_dryrun
    out = str(Path(__file__).resolve().parent / "artifacts" /
              "solver_chip_smoke")
    cells = solver_dryrun.run_batched(DRYRUN_TENANTS, out)
    rows = solver_dryrun.verify(SEQ_RANKS, "primal", world=world,
                                tenants=DRYRUN_TENANTS)
    stats["batched_dryrun"] = {"cells": cells, "verified": rows}
    gates.check("14d batched cells",
                all(r["all_reduces_by_rank"] == [8 // r["s"]] * SEQ_RANKS
                    for r in rows)
                and all(c["all_reduces"] == 8 // c["s"] for c in cells),
                f"H all-reduces by rank at T = {DRYRUN_TENANTS}: "
                + ", ".join(f"s={r['s']}: {r['all_reduces_by_rank']}"
                            for r in rows))


def lasso_check(gates, dev, stats) -> dict:
    """14e: launch/lasso.py on the card (counted: the "lasso" path)."""
    from repro_torch.launch import lasso
    gk.reset_launch_counts()
    res, secs = timed(lambda: lasso.main(device=dev))
    counts = launches()
    stats["lasso"] = {k: res[k] for k in ("deviation", "nnz", "recovered")}
    stats["lasso"]["s"] = secs
    gates.check("14e lasso",
                res["deviation"] < lasso.TOL
                and res["recovered"] == lasso.K,
                f"max |objective s={lasso.S} - s=1| {res['deviation']:.3e} "
                f"(tol {lasso.TOL:g}); recovered {res['recovered']}/{lasso.K},"
                f" nnz {res['nnz']}; {secs:.1f} s; K1 {counts[gk.ROWS_PACKET.name]}"
                f" / K2 {counts[gk.ROWS_APPLY.name]} launches")
    return counts


def dryrun_phase(seed: int, stats: dict, dev=None, world=None) -> dict:
    """Phase 14: (a) flash-decoding and (b) decode on a sequence-sharded
    cache on SEQ_RANKS gloo ranks sharing the card, (c) the LM dry run and
    roofline, (d) the batched solver dry-run cells verified on the ranks,
    (e) the lasso entry point (counted: the returned launches), on
    ``world`` when given (its caller closes it).  Raises at the end if any
    gate failed."""
    dev = torch.device("cuda") if dev is None else dev
    gates = Gates()
    own = world is None
    # 14d's solves need the ranks to load the built kernels
    world = spawn_world(dev, SEQ_RANKS, kernels=True) if own else world
    try:
        for name, fn in (
                ("14a", lambda: flash_decoding_check(world, gates, dev, seed,
                                                     stats)),
                ("14b", lambda: sharded_decode_check(world, gates, dev, seed,
                                                     stats)),
                ("14c", lambda: dryrun_check(world, gates, dev, seed,
                                             stats)),
                ("14d", lambda: batched_dryrun_check(world, gates, dev,
                                                     stats))):
            _, secs = timed(fn)
            stats[f"phase{name}_s"] = secs
            log(f"  {name} took {secs:.1f} s")
            torch.cuda.empty_cache()
    finally:
        if own:
            world.close()
    counts, secs = timed(lambda: lasso_check(gates, dev, stats))
    stats["phase14e_s"] = secs
    log(f"  14e took {secs:.1f} s")
    if gates.failed:
        raise AssertionError(f"phase 14 gates failed: {gates.failed}")
    return counts


# ---------------------------------------------------------------------------
# Phase 15: experts sharded over ranks
# ---------------------------------------------------------------------------
# Four gloo ranks share the card (as phases 9 and 14); the weights reach
# them by CUDA IPC from this process (no copy), each rank takes views of its
# E / P experts.  Widths are the published ones; the cuts, and why: 15a is
# one MoE block (a layer's experts: dbrx 12.7 GB, jamba 38.7 GB in f32);
# 15b is dbrx at EP_DECODE_LAYERS of its 40 layers (31 GB in f32; its 40
# layers are 254 GB of experts in bf16), at phase 12's MOE_GATE_CAPACITY:
# prefill + decode equals forward only where no slot drops (a decode step's
# few tokens never fill a capacity of 8); 15c is phi3.5-moe at
# EP_TRAIN_LAYERS of its 32 layers (a layer's f32 train state is 25 GB of
# experts; the one-rank step and the four ranks' states take the card).
# The router of a random init is balanced, so 15a's tokens share an offset
# (EP_SHIFT N(0, 1) per feature: each expert's logit gets a bias of spread
# about EP_SHIFT) and some experts run hot: at the published capacity 1.25
# slots drop, as they do in a trained router.
EP_RANKS = 4
EP_BLOCK = (("dbrx_132b", "dbrx"), ("jamba_1_5_large_398b", "jamba"))
EP_TOKENS = (4, 512)            # B x S: a rank's 512 tokens
EP_SHIFT = 0.5
EP_REPS = 3
# f32: the ranks' router runs on 512 rows, the one process's on 2048 (cuBLAS
# may split either sum otherwise), and the experts' bmm on an (E / P, C, D)
# slice; outputs of order 1
EP_TOL = 1e-4
EP_DECODE_LAYERS = 2
EP_PROMPT, EP_STEPS, EP_MAX_SEQ = 61, 3, 128
EP_SERVE_PROMPTS = (17, 40)
EP_BF16_STEPS = 8
EP_TRAIN_LAYERS = 1
EP_TRAIN_BATCH = (4, 512)
# the random router is balanced: at the published 1.25 no slot of 2048
# tokens would drop, at 1.0 some do (as in the CPU test of the step)
EP_TRAIN_CAPACITY = 1.0
# one step on the ranks against one rank, f32: sums regrouped (the
# replicated leaves' gradients, the router's, the grad norm): m (the
# clipped gradient's moment) against its norm; each master leaf's
# difference against its move -- Adam's first step moves an element by
# about lr sign(g), so an element whose gradient is within rounding of 0
# steps either way.  The first card run read the embedding's master at
# 1.15e-2 and the attention's wq's m at 2.78e-4 (gates set at 1e-2 and
# 1e-4 before it); the witness, one_rank_spread: the one-rank step run
# again gives the same bits, and with cuBLASLt (the same products, summed
# in another order) moves those leaves by 8.8e-3 and 2.0e-4 from itself
EP_TRAIN_TOL = {"loss": 1e-5, "aux": 1e-5, "grad_norm": 1e-4, "m": 1e-3,
                "master": 2e-2}
EP_RECORDS = (("dbrx_132b", 4), ("dbrx_132b", 16),
              ("jamba_1_5_large_398b", 4), ("jamba_1_5_large_398b", 16))


def wire_ms(counters: dict) -> dict:
    """Host ms inside each kind of collective of one ``Comm`` record."""
    return {"all_to_all": counters["a2a_s"] * 1e3,
            "all_gather": counters["gather_s"] * 1e3,
            "all_reduce": counters["reduce_s"] * 1e3}


def bmm_slices_equal(w1, tokens: int, cfg, dev, gen) -> bool:
    """cuBLAS's bmm of each rank's (E / P, C, D) slice of the experts'
    buffers, joined, against the one (E, C, D) call, at the capacity C of
    ``tokens`` tokens: the same bits?"""
    from repro_torch.models import moe
    m = cfg.moe
    C = moe._capacity(tokens, m.top_k, m.num_experts, m.capacity_factor)
    buf = torch.randn((m.num_experts, C, cfg.d_model), generator=gen,
                      device=dev)
    whole = torch.bmm(buf, w1)
    per = m.num_experts // EP_RANKS
    parts = torch.cat([torch.bmm(buf[i:i + per], w1[i:i + per])
                       for i in range(0, m.num_experts, per)])
    return torch.equal(whole, parts)


def ep_block_check(world, gates, dev, seed: int, stats, arch: str,
                   tag: str) -> None:
    """15a: one MoE block at ``arch``'s width, f32, on EP_RANKS ranks
    against the single-process block on the same weights and tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch import expert_parallel as EPL
    from repro_torch.models import moe
    from repro_torch.models.module import init_params, param_bytes
    cfg = dataclasses.replace(get_config(arch), dtype=torch.float32,
                              param_dtype=torch.float32)
    m = cfg.moe
    gen = torch.Generator(device=dev).manual_seed(seed)
    specs = moe.moe_specs(cfg)
    p = init_params(specs, gen, dev)
    B, S = EP_TOKENS
    D = cfg.d_model
    x = torch.randn((B, S, D), generator=gen, device=dev) + EP_SHIFT * \
        torch.randn((D,), generator=gen, device=dev)
    with torch.no_grad():
        moe.moe_block(p, x, cfg)                     # warm-up
        (want, wm), secs = timed(lambda: moe.moe_block(p, x, cfg))
        whole = moe._route(p, x.reshape(-1, D), cfg)
        rows = [moe._route(p, xs, cfg)
                for xs in x.reshape(EP_RANKS, -1, D)]
        routing = torch.equal(torch.cat([r["sel"] for r in rows]),
                              whole["sel"])
        counts = whole["counts"].tolist()
        sliced = bmm_slices_equal(p["w1"], EP_TOKENS[0] * EP_TOKENS[1],
                                  cfg, dev, gen)
    want = want.cpu()
    del whole, rows
    torch.cuda.empty_cache()
    got = EPL.ep_block(world, cfg, p, x, EP_RANKS, reps=EP_REPS)
    err = float((got["out"] - want).abs().max())
    equal = torch.equal(got["out"], want)
    drop = float(got["metrics"]["moe_drop_frac"])
    drop_equal = torch.equal(got["metrics"]["moe_drop_frac"],
                             wm["moe_drop_frac"].cpu())
    aux_rel = abs(float(got["metrics"]["moe_aux_loss"])
                  - float(wm["moe_aux_loss"])) / float(wm["moe_aux_loss"])
    last = [cs[-1] for cs in got["counters"]]
    block_ms = float(np.median([max(r[i] for r in got["block_s"])
                                for i in range(1, EP_REPS)])) * 1e3
    C = moe._capacity(B * S, m.top_k, m.num_experts, m.capacity_factor)
    rec = {"experts_gb": param_bytes(specs) / 1e9, "capacity": C,
           "counts": counts, "drop_frac": drop, "max_abs_err": err,
           "equal": equal, "bmm_slices_equal": sliced,
           "routing_equal": routing, "aux_rel": aux_rel,
           "one_process_ms": secs * 1e3, "ranks_ms": block_ms,
           "all_to_alls": [c["all_to_alls"] for c in last],
           "all_gathers": [c["all_gathers"] for c in last],
           "all_reduces": [c["all_reduces"] for c in last],
           "a2a_bytes_a_call": [c["a2a_bytes"] / max(c["all_to_alls"], 1)
                                for c in last],
           "wire_ms": [wire_ms(c) for c in last]}
    stats[f"ep_block_{tag}"] = rec
    gates.check(
        f"15a {tag} block on {EP_RANKS} ranks",
        (equal or err <= EP_TOL) and routing and drop_equal and drop > 0
        and aux_rel <= 1e-5 and all(n == 2 for n in rec["all_to_alls"]),
        f"d {D}, d_ff {cfg.d_ff}, {m.num_experts} experts top-{m.top_k}, "
        f"{rec['experts_gb']:.1f} GB of f32 experts; {B * S} tokens, "
        f"capacity {C} at {m.capacity_factor}, counts {counts}; output "
        f"{'torch.equal' if equal else f'max abs err {err:.2e}'} (tol "
        f"{EP_TOL:g}); routing equal {routing}; drop fraction {drop:.4f} "
        f"equal {drop_equal}; aux rel {aux_rel:.1e}; bmm on (E/P, C, D) "
        f"slices == the (E, C, D) call: {sliced}; all-to-alls "
        f"{rec['all_to_alls']}, "
        f"{[round(b / 1e6, 2) for b in rec['a2a_bytes_a_call']]}"
        f" MB a call a rank, host ms inside them "
        f"{[round(w['all_to_all'], 2) for w in rec['wire_ms']]}; the block "
        f"{block_ms:.1f} ms on the ranks against {secs * 1e3:.1f} ms in one "
        f"process")
    del p, x, got


def ep_bits_check(world, gates, cfg, params, model, prompt, feed,
                  bits: bool, stats) -> None:
    """15b, the ranks against one process bit for bit: the same decode
    traced on both sides (launch/expert_parallel.first_difference: every
    MoE call's input, router probabilities, selection, expert outputs, the
    slots it combines and the result, then the logits).  Either the same
    bits, or the first tensor that differs is an expert product of a decode
    step, with the prefill (its MoE calls and logits) and every tensor
    before it equal, the selections equal in every call, and the cause
    reproduced in one process: cuBLAS's bmm on the ranks' (E / P, C, D)
    slices departs from the (E, C, D) call at the decode's capacity C,
    while it gives the same bits at the prefill's."""
    from repro_torch.launch import expert_parallel as EPL
    trace = EPL.first_difference(world, cfg, params, model, prompt, EP_STEPS,
                                 EP_MAX_SEQ, EP_RANKS, feed=feed)
    recs, first = trace["records"], trace["first"]
    stats["ep_trace"] = [list(r) for r in recs]
    prefill_calls = EP_DECODE_LAYERS * cfg.moe.groups
    prefill = all(eq for c, name, eq, _ in recs
                  if name == "prefill logits" or (
                      c <= prefill_calls and not name.endswith("logits")))
    routes = all(eq for _, name, eq, _ in recs if name == "selection")
    gen = torch.Generator(device=model.device).manual_seed(EP_STEPS)
    w1 = params["blocks"]["sub0"]["moe"]["w1"][0]
    B = prompt.shape[0]
    witness = {"prefill": bmm_slices_equal(w1, B * EP_PROMPT, cfg,
                                           model.device, gen),
               "decode": bmm_slices_equal(w1, B, cfg, model.device, gen)}
    stats["ep_bits_witness"] = witness
    where = ("none" if first is None else
             f"{first[1]} of MoE call {first[0]} (max abs {first[3]:.2e}; "
             f"every earlier tensor equal)")
    log(f"    15b trace: {len(recs)} tensors ({recs[-3][0]} MoE calls: "
        f"{EP_DECODE_LAYERS} layers x prefill and {EP_STEPS} steps); the "
        f"first that differs: {where}; the prefill equal {prefill}; "
        f"selections equal in every call {routes}; bmm on (E / P, C, D) "
        f"slices == the (E, C, D) call at the prefill's C {witness['prefill']}"
        f", at the decode's C {witness['decode']}")
    cause = (first is not None and first[1] == "expert outputs"
             and first[0] > prefill_calls and prefill and routes
             and witness["prefill"] and not witness["decode"])
    gates.check("15b ranks against one process's bits",
                (bits and first is None) or (not bits and cause),
                f"the same bits {bits}; first differing tensor {where}")


def ep_decode_check(world, gates, dev, seed: int, stats) -> None:
    """15b: dbrx at its width cut to EP_DECODE_LAYERS layers on EP_RANKS
    ranks: prefill + decode against forward and the engine's tokens
    against one rank's, f32; then bf16 decode ms a step."""
    from repro_torch.configs import get_config
    from repro_torch.launch import expert_parallel as EPL
    from repro_torch.models import api
    from repro_torch.models.module import init_params, param_bytes
    from repro_torch.serve import Engine, ServeConfig
    cfg = get_config("dbrx_132b")
    cfg = dataclasses.replace(cfg, n_layers=EP_DECODE_LAYERS,
                              dtype=torch.float32, param_dtype=torch.float32,
                              moe=dataclasses.replace(
                                  cfg.moe,
                                  capacity_factor=MOE_GATE_CAPACITY))
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(api.param_specs(cfg), gen, dev)
    model = api.build_model(cfg, params)
    tokens = torch.randint(0, cfg.vocab, (2, EP_PROMPT + EP_STEPS),
                           generator=gen, device=dev)
    with torch.no_grad():
        full, _ = api.forward(model, cfg, {"tokens": tokens})
    want = full[:, EP_PROMPT - 1:, :].float().cpu()
    del full
    prompt, feed = tokens[:, :EP_PROMPT], tokens[:, EP_PROMPT:]
    one = EPL.decode(model, cfg, prompt, EP_STEPS, EP_MAX_SEQ, feed=feed)
    got = EPL.ep_decode(world, cfg, params, prompt, EP_STEPS, EP_MAX_SEQ,
                        EP_RANKS, feed=feed)
    errs, bad = [], 0
    for g, w in [(got["prefill"], want[:, 0])] + [
            (got["logits"][i], want[:, 1 + i]) for i in range(EP_STEPS)]:
        errs.append(float((g - w).abs().max()))
        bad += int(((g - w).abs() > LM_TOL + LM_TOL * w.abs()).sum())
    bits = torch.equal(got["logits"], one["logits"]) and torch.equal(
        got["prefill"], one["prefill"])
    gates.check("15b dbrx prefill + decode on the ranks == forward",
                bad == 0 and got["all_gathers"] == [EP_DECODE_LAYERS] *
                EP_STEPS,
                f"{EP_DECODE_LAYERS} layers, f32, B = 2, prompt {EP_PROMPT},"
                f" {EP_STEPS} steps: max abs err {max(errs):.2e} (rtol / "
                f"atol {LM_TOL:g}, entries outside {bad}); the same bits as "
                f"one process's decode: {bits}; all-gathers a step "
                f"{got['all_gathers']}")
    ep_bits_check(world, gates, cfg, params, model, prompt, feed, bits,
                  stats)
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, size=n)))
               for n in EP_SERVE_PROMPTS]
    serve = ServeConfig(max_seq=EP_MAX_SEQ, slots=2, min_bucket=16)
    with torch.no_grad():
        want_tok = Engine(cfg, model, serve).generate(prompts, ORACLE_NEW)
    got_tok = EPL.ep_serve(world, cfg, params, prompts, ORACLE_NEW, serve,
                           EP_RANKS)
    gates.check("15b dbrx engine on the ranks == one rank's",
                got_tok == want_tok,
                f"{len(prompts)} requests of {list(EP_SERVE_PROMPTS)} "
                f"tokens x {ORACLE_NEW} new through 2 slots: {got_tok}")
    del model, one
    torch.cuda.empty_cache()
    # bf16 decode: one process, then the ranks (each casts its shard)
    cfg16 = dataclasses.replace(cfg, dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16)
    model16 = api.build_model(cfg16, api._to_specs(params,
                                                   api.param_specs(cfg16)))
    local = EPL.decode(model16, cfg16, prompt, EP_BF16_STEPS, EP_MAX_SEQ)
    del model16
    torch.cuda.empty_cache()
    ranks = EPL.ep_decode(world, cfg, params, prompt, EP_BF16_STEPS,
                          EP_MAX_SEQ, EP_RANKS, dtype=torch.bfloat16)
    specs16 = api.param_specs(cfg16)
    experts = param_bytes(api.param_specs(cfg16, experts_only=True))
    weights = param_bytes({k: v for k, v in specs16.items()
                           if k != "embedding"})
    bound_local = weights / HBM_BYTES_PER_S * 1e3
    # four ranks on one card: each reads the replicated weights, the
    # experts once between them
    bound_ranks = (EP_RANKS * (weights - experts) + experts) / \
        HBM_BYTES_PER_S * 1e3
    ms_local = float(np.median(local["step_s"][1:])) * 1e3
    ms_ranks = float(np.median(ranks["step_s"][1:])) * 1e3
    stats["ep_decode"] = {"errs": errs, "bits_equal_one_process": bits,
                          "tokens": got_tok, "bf16_local_ms": ms_local,
                          "bf16_ranks_ms": ms_ranks,
                          "bound_local_ms": bound_local,
                          "bound_ranks_ms": bound_ranks,
                          "weights_gb": weights / 1e9,
                          "experts_gb": experts / 1e9}
    log(f"    15b dbrx bf16 decode ({EP_DECODE_LAYERS} layers, B = 2, "
        f"{EP_BF16_STEPS} greedy steps, median of steps 2-{EP_BF16_STEPS}):"
        f" {ms_ranks:.2f} ms a step on {EP_RANKS} ranks (the slowest rank; "
        f"bound {bound_ranks:.3f} ms: the replicated weights read by every "
        f"rank, the experts once) against {ms_local:.2f} ms in one process "
        f"(bound {bound_local:.3f} ms: {weights / 1e9:.2f} GB of bf16 "
        f"weights read a step, {experts / 1e9:.2f} GB of them experts)")
    del params


def ep_decode_f64_check(gates, dev, seed: int, stats) -> None:
    """15b's gate against forward in f64, in one process: dbrx at its width
    cut to EP_DECODE_LAYERS layers (15b's draw, each leaf cast to f64 as it
    is drawn: about 62 GB), prefill + decode steps against forward at
    phases 11-12's tolerance, LM_TOL.  f64 rounding leaves the gate nothing
    of the draw's to amplify (15b's f32 reading stays a report).  If the
    weights and one f32 leaf do not fit the card's free memory, one layer
    (the cut is logged)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import expert_parallel as EPL
    from repro_torch.models import api
    from repro_torch.models.module import init_params, param_bytes
    base = get_config("dbrx_132b")
    free = torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda" else None
    for layers in (EP_DECODE_LAYERS, 1):
        cfg = dataclasses.replace(
            base, n_layers=layers, dtype=torch.float64,
            param_dtype=torch.float64,
            moe=dataclasses.replace(base.moe,
                                    capacity_factor=MOE_GATE_CAPACITY))
        specs = api.param_specs(cfg)
        need = param_bytes(specs) * 1.2      # a leaf drawn in f32 besides
        if free is None or need <= free:
            break
    cut = "" if layers == EP_DECODE_LAYERS else (
        f"; cut to {layers} layer: {need / 1e9:.1f} GB over the card's "
        f"{free / 1e9:.1f} GB free")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = api.build_model(cfg, init_params(specs, gen, dev))
    tokens = torch.randint(0, cfg.vocab, (2, EP_PROMPT + EP_STEPS),
                           generator=gen, device=dev)
    with torch.no_grad():
        full, _ = api.forward(model, cfg, {"tokens": tokens})
    want = full[:, EP_PROMPT - 1:, :].cpu()
    del full
    got = EPL.decode(model, cfg, tokens[:, :EP_PROMPT], EP_STEPS, EP_MAX_SEQ,
                     feed=tokens[:, EP_PROMPT:])
    errs, bad = [], 0
    for g, w in [(got["prefill"], want[:, 0])] + [
            (got["logits"][i], want[:, 1 + i]) for i in range(EP_STEPS)]:
        g = g.to(w.dtype)
        errs.append(float((g - w).abs().max()))
        bad += int(((g - w).abs() > LM_TOL + LM_TOL * w.abs()).sum())
    peak = torch.cuda.max_memory_allocated() / 1e9
    f32 = stats.get("ep_decode", {}).get("errs")
    stats["ep_decode_f64"] = {"layers": layers, "errs": errs, "peak_gb": peak,
                              "weights_gb": param_bytes(specs) / 1e9}
    gates.check("15b dbrx prefill + decode == forward, f64, one process",
                bad == 0,
                f"{layers} layers at dbrx's width, "
                f"{param_bytes(specs) / 1e9:.1f} GB of f64 weights, peak "
                f"{peak:.1f} GB{cut}: max abs err {max(errs):.2e} (rtol / "
                f"atol {LM_TOL:g}, entries outside {bad}); 15b's f32 "
                f"reading on the ranks, reported: "
                f"{max(f32) if f32 else float('nan'):.2e}")
    del model, got


def one_rank_spread(cfg, params, batch, want, dev) -> dict:
    """The one-rank step's spread against itself: the same first step from
    the same state, once more with the default BLAS library and once with
    cuBLASLt preferred (the same products, their sums in another order),
    each leaf held against ``want`` as the ranks' are
    (``expert_parallel._errors``)."""
    from repro_torch.launch import expert_parallel as EPL
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    default = torch.backends.cuda.preferred_blas_library()
    out = {}
    for tag, lib in (("rerun", default), ("cublaslt", "cublaslt")):
        state = {"params": clone_tree(params), "opt": init_opt_state(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        torch.backends.cuda.preferred_blas_library(lib)
        try:
            state, _ = step(state, batch)
        finally:
            torch.backends.cuda.preferred_blas_library(default)
        out[tag] = EPL._errors(state["opt"], want, params, None, dev)
        del state
        torch.cuda.empty_cache()
    return out


def ep_train_check(world, gates, dev, seed: int, stats) -> None:
    """15c: phi3.5-moe at its width cut to EP_TRAIN_LAYERS layer on
    EP_RANKS ranks against one rank, f32: the first train step's metrics,
    master and m held against each other, the second step timed."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.launch import expert_parallel as EPL
    from repro_torch.models import api
    from repro_torch.models.module import init_params, tree_map
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    cfg = get_config("phi3_5_moe_42b")
    cfg = dataclasses.replace(cfg, n_layers=EP_TRAIN_LAYERS,
                              dtype=torch.float32, param_dtype=torch.float32,
                              moe=dataclasses.replace(
                                  cfg.moe, capacity_factor=EP_TRAIN_CAPACITY))
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(api.param_specs(cfg), gen, dev)
    B, S = EP_TRAIN_BATCH
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             synthetic_lm_batch(cfg.vocab, S, B, seed=seed).items()}
    with torch.no_grad():
        _, fwd = api.forward(api.build_model(cfg, params), cfg, batch)
    state = {"params": clone_tree(params), "opt": init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    (state, one), first_s = timed(lambda: step(state, batch))
    # the first step's master and m, on the host (the ranks read them
    # there, a leaf at a time): the card keeps room for four states
    want = {k: tree_map(lambda t: t.to("cpu", copy=True), state["opt"][k],
                        is_leaf=torch.is_tensor) for k in ("master", "m")}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (state, _), secs = timed(lambda: step(state, batch))
    one_peak = torch.cuda.max_memory_allocated() - base
    del state
    torch.cuda.empty_cache()
    spread = one_rank_spread(cfg, params, batch, want, dev)
    got = EPL.ep_train_step(world, cfg, params, batch, EP_RANKS, lr=1e-3,
                            want=want, steps=2)
    tm, fm = got["metrics"], got["forward"]
    rel = {k: abs(tm[k] - float(one[k])) / abs(float(one[k]))
           for k in ("loss", "moe_aux_loss", "grad_norm")}
    worst = {k: max(((n, e) for n, e in got["err"].items()
                     if n.startswith(k + "/")), key=lambda kv: kv[1])
             for k in ("master", "m")}
    drop_equal = fm["moe_drop_frac"] == float(fwd["moe_drop_frac"])
    # the one-rank step's own spread on the ranks' worst leaves, and its
    # worst leaves
    witness = {tag: {"at_ranks_worst": {k: errs[worst[k][0]]
                                        for k in worst},
                     "worst": {k: max(((n, e) for n, e in errs.items()
                                       if n.startswith(k + "/")),
                                      key=lambda kv: kv[1])
                               for k in worst}}
               for tag, errs in spread.items()}
    ms = max(s[1] for s in got["step_s"]) * 1e3
    wires = [wire_ms(c) for c in got["counters"]]
    stats["ep_train"] = {"rel": rel, "worst": worst,
                         "drop_frac": fm["moe_drop_frac"],
                         "ranks_ms": ms, "one_rank_ms": secs * 1e3,
                         "first_step_ms": {
                             "one": first_s * 1e3,
                             "ranks": max(s[0] for s in got["step_s"]) * 1e3},
                         "one_rank_peak_gb": one_peak / 1e9,
                         "peak_gb": [(b or 0) / 1e9
                                     for b in got["peak_bytes"]],
                         "wire_ms": wires, "one_rank_spread": witness,
                         "all_to_alls": [c["all_to_alls"]
                                         for c in got["counters"]]}
    gates.check(
        "15c phi3.5-moe train step on the ranks == one rank",
        rel["loss"] <= EP_TRAIN_TOL["loss"]
        and rel["moe_aux_loss"] <= EP_TRAIN_TOL["aux"]
        and rel["grad_norm"] <= EP_TRAIN_TOL["grad_norm"]
        and drop_equal and worst["m"][1] <= EP_TRAIN_TOL["m"]
        and worst["master"][1] <= EP_TRAIN_TOL["master"],
        f"{EP_TRAIN_LAYERS} layer, f32, {B} x {S} tokens: loss "
        f"{tm['loss']:.6f} (rel {rel['loss']:.1e}), aux "
        f"{tm['moe_aux_loss']:.6f} (rel {rel['moe_aux_loss']:.1e}), grad "
        f"norm {tm['grad_norm']:.4f} (rel {rel['grad_norm']:.1e}), drop "
        f"fraction {fm['moe_drop_frac']:.4f} equal {drop_equal}; worst m "
        f"leaf {worst['m'][0]} {worst['m'][1]:.2e} of its norm (tol "
        f"{EP_TRAIN_TOL['m']:g}), worst master leaf {worst['master'][0]} "
        f"{worst['master'][1]:.2e} of its move (tol "
        f"{EP_TRAIN_TOL['master']:g}); one rank against itself on those "
        f"leaves (m, master): rerun "
        f"{witness['rerun']['at_ranks_worst']['m']:.2e}, "
        f"{witness['rerun']['at_ranks_worst']['master']:.2e}, cuBLASLt "
        f"{witness['cublaslt']['at_ranks_worst']['m']:.2e}, "
        f"{witness['cublaslt']['at_ranks_worst']['master']:.2e} (its worst "
        f"cuBLASLt leaves {witness['cublaslt']['worst']['m']}, "
        f"{witness['cublaslt']['worst']['master']}); the second step "
        f"{ms:.1f} ms on "
        f"{EP_RANKS} ranks (the slowest) against {secs * 1e3:.1f} ms on one"
        f" (first steps {first_s * 1e3:.0f} / "
        f"{stats['ep_train']['first_step_ms']['ranks']:.0f} ms); host ms in "
        f"the collectives by rank {[round(sum(w.values()), 1) for w in wires]}"
        f"; allocator peaks "
        f"{[round((b or 0) / 1e9, 2) for b in got['peak_bytes']]} GB a rank,"
        f" {one_peak / 1e9:.2f} GB on one rank")
    del params, want


def ep_records_check(gates, dev, stats) -> None:
    """15d: the MoE train cells of phase 14c on EP_RANKS ranks (probed or
    skipped for memory), and dbrx's and jamba's analytic records at 4 and
    16 ranks."""
    import tempfile

    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    cells = [r for r in stats.get("dryrun", {}).get("records", [])
             if r["cell"][2] == f"p{SEQ_RANKS}" and r["cell"][1] == "train_4k"
             and "llama" not in r["cell"][0]]
    for r in cells:
        base, probe = r.get("base", {}), r.get("probe") or {}
        log(f"    15d {r['cell'][0]} train_4k p{SEQ_RANKS}: "
            f"{base.get('status')}"
            f", probe {probe.get('status')}"
            + (f" ({probe.get('reason', '')[:150]})"
               if probe.get("status") == "skipped" else ""))
    recs = []
    with tempfile.TemporaryDirectory() as out:
        for arch, P in EP_RECORDS:
            for shape in SHAPES:
                rec = dryrun.run_cell(arch, shape, P, out, verbose=False,
                                      device=dev)
                mem = rec.get("memory_analysis") or {}
                recs.append({"arch": arch, "shape": shape, "ranks": P,
                             "status": rec["status"],
                             "argument_gb": (mem.get("argument_bytes") or 0)
                             / 1e9,
                             "experts": (rec.get("reduced") or {}).get(
                                 "experts")})
    for r in recs:
        log(f"    15d {r['arch']} {r['shape']} p{r['ranks']}: {r['status']}, "
            f"{r['argument_gb']:.1f} GB of arguments a rank"
            + (f" ({r['experts']})" if r["experts"] else ""))
    stats["ep_records"] = recs
    gates.check("15d the MoE cells on ranks",
                len(cells) == 3 and all(
                    r["base"]["status"] == "ok" for r in cells)
                and all(r["status"] in ("ok", "skipped") for r in recs),
                f"{len(cells)} MoE train cells on {SEQ_RANKS} ranks; "
                f"{sum(r['status'] == 'ok' for r in recs)} of {len(recs)} "
                "analytic records at 4 and 16 ranks ok")


def release_ranks(world) -> None:
    """Every rank's cached blocks given back to the card it shares (and
    this process's), between two phases on one world."""
    from repro_torch.launch.flash_decode import release_rank
    world.run(release_rank, world.size)
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()


def spawn_world(dev, n_ranks: int, kernels: bool = False):
    from repro_torch.core import SolverWorld
    world, secs = timed(lambda: SolverWorld(n_ranks, device=dev,
                                            kernels=kernels))
    log(f"  {n_ranks} gloo ranks spawned in {secs:.1f} s")
    return world


def experts_phase(seed: int, stats: dict, dev=None, world=None) -> dict:
    """Phase 15: experts sharded over EP_RANKS gloo ranks sharing the card
    (plain torch and collectives: the returned launch counts are all
    zero), on ``world`` when given (its caller closes it).  Raises at the
    end if any gate failed."""
    dev = torch.device("cuda") if dev is None else dev
    gates = Gates()
    gk.reset_launch_counts()
    own = world is None
    world = spawn_world(dev, EP_RANKS) if own else world
    try:
        steps = [(f"15a {tag}", lambda a=arch, t=tag: ep_block_check(
            world, gates, dev, seed, stats, a, t)) for arch, tag in EP_BLOCK]
        steps += [("15b", lambda: ep_decode_check(world, gates, dev, seed,
                                                  stats)),
                  ("15b f64", lambda: ep_decode_f64_check(gates, dev, seed,
                                                          stats)),
                  ("15c", lambda: ep_train_check(world, gates, dev, seed,
                                                 stats))]
        for name, fn in steps:
            _, secs = timed(fn)
            stats[f"phase{name.replace(' ', '_')}_s"] = secs
            log(f"  {name} took {secs:.1f} s")
            torch.cuda.ipc_collect()    # what the ranks held by IPC
            torch.cuda.empty_cache()
    finally:
        if own:
            world.close()
    ep_records_check(gates, dev, stats)
    counts = launches()
    if gates.failed:
        raise AssertionError(f"phase 15 gates failed: {gates.failed}")
    return counts


# ---------------------------------------------------------------------------
# Phase 16: the reference's production layout on a grid of ranks
# ---------------------------------------------------------------------------
# Four gloo ranks share the card: phase 14's world, shared by phases 13f-18;
# weights reach them by CUDA IPC, each rank copies its blocks
# (train.trainer.place_fresh).  llama3.2-3b at its published width cut to
# GRID_LAYERS of its 28 layers in f32; 16a at GRID_ZERO1_LAYERS: its
# replicated world holds four whole states at once, and at 4 layers a
# rank's 3.19 GB of weights, as much gradient, 9.56 GB of optimizer state
# and the gradient all-reduce's 3.19 GB buffer came to 19 GB a rank, 76 GB
# for four (the card's first run: out of memory; 2 layers ran, 16.7 GB
# a rank, at about 11 s a step of host-staged gloo, so 1 keeps the whole
# run near its time).  GRID_BATCH rows x tokens a step, the rows over
# 'data'.  16b / 16c hold one step of the grid to one process at 15c's
# gates, m's included (Adam's first move is m / sqrt(v), about the sign of
# the gradient whatever its scale, so the master's move alone would not
# see a leaf's gradient scaled wrongly; m is the gradient's own scale)
# (the sums regroup: rows over 'data', heads and vocab columns over
# 'model') and time it beside the one process's; the f64 twin at
# GRID_F64_LAYERS layer holds the loss at GRID_F64_TOL.  Their weights are
# drawn as init_params draws them, the attention projections rescaled to
# their fan-in (attention_fan_in, as 13c / 13d): under the reference's own
# init the first card run read a gradient norm of 3.6e4 at 4 layers, and
# the f32 sums regrouped over the grid moved it by 15 % (the f64 twin
# agreed to 1.5e-16; one process with its rows regrouped moves as far,
# launch/f32_spread.py).  16d uses the cpu-small preset's width
# (launch/train.py): a checkpoint of the full width's state would be
# 13 GB on the disk.  16b / 16c run GRID_LAYERS = 1 of 28 layers (4 until
# phase 17 came, 2 until phase 18 came: their seconds are taken back here,
# a step of host-staged gloo being about linear in the layers' bytes;
# phase 18a steps 2 + 2 layers of the same grid code in f32).
GRID_RANKS = EP_RANKS
GRID_LAYERS = 1
GRID_ZERO1_LAYERS = 1
GRID_F64_LAYERS = 1
GRID_BATCH = (4, 512)
GRID_STEPS = 1                  # 16a's (2 until phase 18 came, the first
                                # at lr 0 under warmup 1: warmup 0 makes
                                # the one step move every master block);
                                # 16b / 16c take one too
GRID_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "m": 1e-3, "master": 2e-2}
GRID_F64_TOL = 1e-10
GRID_MESHES = ("single", "multi")


def grid_cfg(layers: int, dtype, **kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3_2_3b"), n_layers=layers,
                               dtype=dtype, param_dtype=dtype, **kw)


def grid_zero1_check(world, gates, dev, seed: int, stats) -> None:
    """16a: ZeRO-1 on (4, 1) against the replicated world, bit for bit."""
    from repro_torch.launch.grid_train import zero1_against_replicated
    from repro_torch.train import TrainRunConfig
    cfg = grid_cfg(GRID_ZERO1_LAYERS, torch.float32)
    B, S = GRID_BATCH
    run = TrainRunConfig(steps=GRID_STEPS, global_batch=B, seq_len=S,
                         lr=1e-4, warmup=0, log_every=1, seed=seed)
    outs = zero1_against_replicated(world, (GRID_RANKS, 1), cfg, run)
    same = all(o["replicated"]["digests"] == o["grid"]["digests"]
               and [h["loss"] for h in o["replicated"]["history"]]
               == [h["loss"] for h in o["grid"]["history"]] for o in outs)
    moved = all(o["grid"]["start"] and all(
        d != dict(o["grid"]["digests"])[k] for k, d in o["grid"]["start"])
        for o in outs)
    opt = [(o["grid"]["opt_bytes"], o["replicated"]["opt_bytes"])
           for o in outs]
    quarter = all(g * GRID_RANKS == r for g, r in opt)
    hist = outs[0]["grid"]["history"]
    stats["grid_16a"] = {
        "loss": [h["loss"] for h in hist],
        "grad_norm": [h["grad_norm"] for h in hist],
        "opt_gb": [g / 1e9 for g, _ in opt],
        "replicated_opt_gb": [r / 1e9 for _, r in opt],
        "peak_gb": {k: [(o[k]["peak_bytes"] or 0) / 1e9 for o in outs]
                    for k in ("grid", "replicated")},
        "run_s": {k: max(o[k]["run_s"] for o in outs)
                  for k in ("grid", "replicated")}}
    gates.check(
        "16a ZeRO-1 on (4, 1) == the replicated world",
        same and moved and quarter
        and all(math.isfinite(h["loss"]) for h in hist),
        f"{GRID_ZERO1_LAYERS} layers, f32, {GRID_STEPS} steps of {B} x {S} "
        f"tokens: every leaf's block the same bytes on each rank "
        f"{same}, every master block moved {moved}, losses {[round(h['loss'], 6) for h in hist]}, grad norm "
        f"{[round(h['grad_norm'], 4) for h in hist]}; optimizer GB a rank "
        f"{[round(g / 1e9, 3) for g, _ in opt]} against "
        f"{[round(r / 1e9, 3) for _, r in opt]} replicated (a quarter: "
        f"{quarter}); peaks GB {stats['grid_16a']['peak_gb']}; the "
        f"{GRID_STEPS} steps {stats['grid_16a']['run_s']} s "
        f"(host-staged gloo)")


def grid_one_process(cfg, dev, seed: int, shape=None) -> tuple:
    """Weights from ``seed`` at fan-in, a batch of ``shape`` (B, S)
    (GRID_BATCH; the family's frontend embeddings with it,
    ``train.trainer.frontend_embeds``) and one train step of ``cfg`` in
    this process: (params, batch, the step's metrics, {"master", "m"}
    after it, its ms)."""
    from repro_torch.data import synthetic_lm_batch
    from repro_torch.models import api
    from repro_torch.models.module import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import frontend_embeds
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(api.param_specs(cfg), gen, dev)
    attention_fan_in(params, cfg)
    B, S = shape or GRID_BATCH
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             synthetic_lm_batch(cfg.vocab, S, B, seed=seed).items()}
    batch.update({k: torch.from_numpy(v).to(dev) for k, v in
                  frontend_embeds(cfg, B, S, seed, 0).items()})
    state = {"params": clone_tree(params), "opt": init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    (state, m1), secs = timed(lambda: step(state, batch))
    want = {k: state["opt"][k] for k in ("master", "m")}
    ms = secs * 1e3
    del state
    torch.cuda.empty_cache()
    return params, batch, {k: float(v) for k, v in m1.items()}, want, ms


def grid_tp_check(world, gates, seed: int, stats, tag: str, fsdp: bool,
                  one: tuple, one64: tuple) -> None:
    """16b / 16c: (2, 2), tensor parallelism and ZeRO-1 (with ``fsdp``
    FSDP too), against one process in f32 and in f64."""
    grid_step_check(world, gates, stats, tag,
                    grid_cfg(GRID_LAYERS, torch.float32, fsdp=fsdp), one,
                    grid_cfg(GRID_F64_LAYERS, torch.float64, fsdp=fsdp),
                    one64, f"{GRID_LAYERS} layer",
                    f"{GRID_F64_LAYERS} layer")


def grid_step_check(world, gates, stats, tag: str, cfg, one: tuple,
                    cfg64=None, one64: tuple | None = None,
                    depth: str = "", depth64: str = "",
                    grid: tuple = (2, 2)) -> None:
    """One train step of ``cfg`` on ``grid`` against the one process's
    (``one``: :func:`grid_one_process`'s) at 15c's gates, and with
    ``cfg64`` the f64 twin's loss at GRID_F64_TOL; ms a step, host ms in
    the collectives, each rank's peak."""
    from repro_torch.launch.grid_train import grid_train_steps
    params, batch, m1, want, one_ms = one
    got = grid_train_steps(world, grid, cfg, params, batch, keep=False,
                           want=want)
    rel64 = None
    if cfg64 is not None:
        p64, b64, m64, _, _ = one64
        g64 = grid_train_steps(world, grid, cfg64, p64, b64, keep=False)
        rel64 = {k: abs(g64["first"][k] - m64[k]) / abs(m64[k])
                 for k in ("loss", "grad_norm")}
    fsdp = cfg.fsdp
    tm = got["first"]
    rel = {k: abs(tm[k] - m1[k]) / abs(m1[k]) for k in ("loss", "grad_norm")}
    worst = {k: max(((n, e) for n, e in got["err"].items()
                     if n.startswith(k + "/")), key=lambda kv: kv[1])
             for k in ("master", "m")}
    ms = max(s[-1] for s in got["step_s"]) * 1e3
    host_ms = [round(h * 1e3, 1) for h in got["host_s"]]
    peaks = [round((b or 0) / 1e9, 2) for b in got["peak_bytes"]]
    kinds = {k: (v["all_reduces"], v["all_gathers"], v["reduce_scatters"])
             for k, v in got["counters"][0].items()}
    stats[f"grid_{tag}"] = {"rel": rel, "worst": worst, "rel64": rel64,
                            "ms": ms, "one_process_ms": one_ms,
                            "host_ms": host_ms, "peak_gb": peaks,
                            "calls_rank0": kinds,
                            "opt_gb": [b / 1e9 for b in got["opt_bytes"]]}
    gates.check(
        f"{tag} {grid}{' FSDP' if fsdp else ''} == one process",
        rel["loss"] <= GRID_TOL["loss"]
        and rel["grad_norm"] <= GRID_TOL["grad_norm"]
        and worst["m"][1] <= GRID_TOL["m"]
        and worst["master"][1] <= GRID_TOL["master"]
        and (rel64 is None or rel64["loss"] <= GRID_F64_TOL),
        f"{card()}; {cfg.name} {depth} f32, one step: loss "
        f"{tm['loss']:.6f} (rel {rel['loss']:.1e}), grad norm "
        f"{tm['grad_norm']:.4f} (rel {rel['grad_norm']:.1e}), worst master "
        f"move {worst['master'][0]} {worst['master'][1]:.2e} (tol "
        f"{GRID_TOL['master']:g}), worst m {worst['m'][0]} "
        f"{worst['m'][1]:.2e} (tol {GRID_TOL['m']:g}); "
        + ("no f64 twin" if rel64 is None else
           f"f64 at {depth64}: loss rel {rel64['loss']:.1e} (tol "
           f"{GRID_F64_TOL:g}), grad norm rel {rel64['grad_norm']:.1e}")
        + f"; the step {ms:.1f} ms on the grid (the "
        f"slowest rank) against {one_ms:.1f} ms in one process (each the "
        f"first); host "
        f"ms in the collectives by rank {host_ms}; rank 0's (all-reduce, "
        f"all-gather, reduce-scatter) calls by group {kinds}; allocator "
        f"peaks {peaks} GB a rank; optimizer GB a rank "
        f"{[round(b / 1e9, 3) for b in got['opt_bytes']]}")


def grid_restart_check(world, gates, seed: int, stats) -> None:
    """16d: a checkpoint on 2 x 2 restored on 1 x 2, the same bits."""
    import tempfile
    from repro_torch.launch.grid_train import restore_on_grid
    from repro_torch.launch.train import PRESETS, build_model_cfg
    from repro_torch.train import TrainRunConfig, run_data_parallel
    cfg = dataclasses.replace(
        build_model_cfg("llama3_2_3b", PRESETS["cpu-small"]),
        dtype=torch.float32, param_dtype=torch.float32)
    ckpt = tempfile.mkdtemp(prefix="grid-ckpt-")
    try:
        run = TrainRunConfig(steps=2, global_batch=4, seq_len=256, lr=1e-3,
                             warmup=1, log_every=1, seed=seed,
                             ckpt_dir=ckpt)
        (saved, save_s) = timed(lambda: run_data_parallel(
            world, cfg, run, grid=(2, 2))["state"])
        got, load_s = timed(lambda: restore_on_grid(world, (1, 2), cfg,
                                                    run))
        want, have = dict(tree_items(saved)), dict(tree_items(got["state"]))
        same = want.keys() == have.keys() and all(
            torch.equal(have[k], want[k]) for k in want)
        nbytes = sum(t.numel() * t.element_size() for t in want.values())
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    stats["grid_16d"] = {"bytes": nbytes, "train_save_s": save_s,
                         "restore_s": load_s}
    gates.check("16d restart 2 x 2 -> 1 x 2 keeps the saved bits",
                same and got["step"] == 2,
                f"{cfg.name} (d_model {cfg.d_model}, {cfg.n_layers} layers, "
                f"f32): "
                f"{nbytes / 1e9:.3f} GB of state, 2 steps and the write "
                f"{save_s:.1f} s, the restore on 1 x 2 {load_s:.1f} s, "
                f"step {got['step']}, every leaf equal {same}")


def grid_dryrun_check(gates, dev, stats) -> None:
    """16e: the analytic records on the reference's meshes."""
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch import dryrun as D
    out = str(Path(__file__).resolve().parent / "artifacts" / "dryrun_grid")
    recs = []
    for mesh in GRID_MESHES:
        recs += D.run(ARCH_IDS, list(SHAPES), probe=False, out_dir=out,
                      device=dev, grid=D.parse_mesh(mesh))
    count = D.summarize(recs)
    train = {(r["arch"], r["mesh"]): round(
        r["memory_analysis"]["alias_bytes"] / 1e9, 3) for r in recs
        if r["shape"] == "train_4k" and r["status"] == "ok"
        and r["arch"] in ("dbrx-132b", "jamba-1.5-large-398b",
                          "llama3.2-3b")}
    stats["grid_16e"] = {"count": count, "train_state_gb": {
        f"{a} {m}": v for (a, m), v in train.items()}}
    gates.check("16e dry run on 16x16 and 2x16x16: no cell fails",
                count["failed"] == 0 and count["ok"] > 0,
                f"{count}; a rank's train_4k state GB {train}")


def grid_phase(seed: int, stats: dict, dev=None, world=None) -> dict:
    """Phase 16: the production layout on a grid of GRID_RANKS gloo ranks
    sharing the card (plain torch and collectives: the returned launch
    counts are all zero), on ``world`` when given (phase 14's: its caller
    closes it).  Raises at the end if any gate failed."""
    dev = torch.device("cuda") if dev is None else dev
    gates = Gates()
    gk.reset_launch_counts()
    own = world is None
    world = spawn_world(dev, GRID_RANKS) if own else world
    one = one64 = None
    try:
        def tp(tag, fsdp):
            nonlocal one, one64
            if one is None:
                one = grid_one_process(grid_cfg(GRID_LAYERS, torch.float32),
                                       dev, seed)
                one64 = grid_one_process(
                    grid_cfg(GRID_F64_LAYERS, torch.float64), dev, seed)
            grid_tp_check(world, gates, seed, stats, tag, fsdp, one, one64)
        for name, fn in (
                ("16a", lambda: grid_zero1_check(world, gates, dev, seed,
                                                 stats)),
                ("16b", lambda: tp("16b", False)),
                ("16c", lambda: tp("16c", True)),
                ("16d", lambda: grid_restart_check(world, gates, seed,
                                                   stats))):
            _, secs = timed(fn)
            stats[f"phase{name}_s"] = secs
            log(f"  {name} took {secs:.1f} s")
            torch.cuda.ipc_collect()
            torch.cuda.empty_cache()
    finally:
        if own:
            world.close()
        one = one64 = None
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
    _, secs = timed(lambda: grid_dryrun_check(gates, dev, stats))
    stats["phase16e_s"] = secs
    log(f"  16e took {secs:.1f} s")
    counts = launches()
    if gates.failed:
        raise AssertionError(f"phase 16 gates failed: {gates.failed}")
    return counts


# ---------------------------------------------------------------------------
# Phase 17: serving in the reference's production layout on a grid of ranks
# ---------------------------------------------------------------------------
# Phase 14's four gloo ranks sharing the card, laid out (2, 2): tensor
# parallelism over 'model', two slots a row over 'data', the decode cache's
# positions over 'model' (cache_seq, the reference's decode_specs) or its
# kv heads (seq_shard=False).  Cuts, and why: 17a runs llama3.2-3b at its
# width and SERVE_GRID_LAYERS of 28 layers in f32 (the one-process run and
# the ranks' blocks of 4 layers: 3.2 GB each; at fan-in, as 16b: the
# reference's init makes f32's rounding chaotic with depth,
# launch/f32_spread.py) and its f64 twin at SERVE_GRID_F64_LAYERS; 17b
# serves the whole 28 layers in bf16 (6.4 GB of weights, 3.2 GB a rank).  Prompts: 17a's four rows of
# SERVE_GRID_PROMPT tokens (lengths SERVE_GRID_LENS, right-padded) decode
# SERVE_GRID_STEPS steps, the first replaying the last prompt token; rows
# 0 and 1 cross the position shards' boundary at 64 of SERVE_GRID_MAX_SEQ.
SERVE_GRID = (2, 2)
SERVE_GRID_LAYERS = 4
SERVE_GRID_F64_LAYERS = 1
SERVE_GRID_PROMPT = 64
SERVE_GRID_LENS = (64, 61, 57, 40)
SERVE_GRID_MAX_SEQ = 128
SERVE_GRID_STEPS = 8
SERVE_GRID_TOL = 1e-4           # of each step's logits' norm (f32)
SERVE_GRID_F64_TOL = 1e-10
SERVE_ENGINE_PROMPTS = 4        # 17b: requests of SERVE_ENGINE_PROMPT tokens
SERVE_ENGINE_PROMPT = 32
SERVE_ENGINE_NEW = 8
SERVE_ENGINE_MAX_SEQ = 64


def serve_grid_params(layers: int, dtype, dev, seed: int) -> tuple:
    """(cfg, params) of llama3.2-3b at its width cut to ``layers``, random
    weights from ``seed`` at fan-in (:func:`attention_fan_in`)."""
    from repro_torch.models import api
    from repro_torch.models.module import init_params
    cfg = grid_cfg(layers, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(api.param_specs(cfg), gen, dev)
    attention_fan_in(params, cfg)
    return cfg, params


def serve_grid_prompts(cfg, dev, seed: int) -> tuple:
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    tokens = torch.randint(0, cfg.vocab, (len(SERVE_GRID_LENS),
                                          SERVE_GRID_PROMPT), generator=gen,
                           device=dev)
    lens = torch.tensor(SERVE_GRID_LENS, device=dev)
    tokens[torch.arange(SERVE_GRID_PROMPT, device=dev)[None, :]
           >= lens[:, None]] = 0
    return tokens, lens


def step_errors(got, want) -> list:
    """Each step's ||got - want|| / ||want|| of (steps + 1, B, V) logits."""
    return [float(torch.linalg.norm(g.double() - w.double())
                  / torch.linalg.norm(w.double())) for g, w in zip(got, want)]


def calls_by_group(calls: dict) -> dict:
    """A rank's ``Comm`` records by group as {group: {kind: calls}}."""
    keys = (("all_reduce", "all_reduces"), ("max", "max_reduces"),
            ("all_gather", "all_gathers"), ("all_to_all", "all_to_alls"))
    out = {}
    for group, c in calls.items():
        kinds = {k: c[n] for k, n in keys if c[n]}
        if kinds:
            out[group] = kinds
    return out


def grid_serve_exactness(world, gates, dev, seed: int, stats) -> None:
    """17a: prefill and SERVE_GRID_STEPS decode steps on SERVE_GRID under
    both cache layouts against one process on the same weights (fed the
    one process's tokens), f32 at SERVE_GRID_LAYERS layers and f64 at
    SERVE_GRID_F64_LAYERS."""
    from repro_torch.launch.grid_serve import grid_serve, one_process_serve
    rec = {}
    for tag, layers, dtype, tol in (
            ("f32", SERVE_GRID_LAYERS, torch.float32, SERVE_GRID_TOL),
            ("f64", SERVE_GRID_F64_LAYERS, torch.float64,
             SERVE_GRID_F64_TOL)):
        cfg, params = serve_grid_params(layers, dtype, dev, seed)
        tokens, lens = serve_grid_prompts(cfg, dev, seed)
        one = one_process_serve(cfg, params, tokens, lens,
                                SERVE_GRID_MAX_SEQ, SERVE_GRID_STEPS)
        one_ms = float(np.median(one["step_s"][1:])) * 1e3
        for seq in (True, False):
            name = f"{tag} {'cache_seq' if seq else 'kv heads'}"
            got = grid_serve(world, SERVE_GRID, cfg, params, tokens, lens,
                             SERVE_GRID_MAX_SEQ, SERVE_GRID_STEPS,
                             feed=one["fed"].to(dev), seq_shard=seq)
            errs = step_errors(got["logits"], one["logits"])
            same = torch.equal(got["picks"], one["picks"])
            ms = max(float(np.median(s[1:])) for s in got["step_s"]) * 1e3
            pre_ms = max(got["prefill_s"]) * 1e3
            host = [round(h * 1e3, 2) for h in got["host_s"]]
            calls = calls_by_group(got["calls"][0])
            pre_calls = calls_by_group(got["prefill_calls"][0])
            rec[name] = {"errs": errs, "tokens_equal": same,
                         "step_ms": ms, "one_process_step_ms": one_ms,
                         "prefill_ms": pre_ms,
                         "one_process_prefill_ms": one["prefill_s"] * 1e3,
                         "host_ms": host, "calls_rank0": calls,
                         "prefill_calls_rank0": pre_calls,
                         "cache_shapes": got["cache_shapes"][0]}
            gates.check(
                f"17a {name} (2, 2) == one process",
                max(errs) <= tol and same,
                f"{card()}; {layers} layers {tag}: prefill + "
                f"{SERVE_GRID_STEPS} decode steps, worst step's logits {max(errs):.2e} of "
                f"their norm (tol {tol:g}); greedy tokens equal {same}; "
                f"rank 0's cache block {got['cache_shapes'][0]['k']}; a "
                f"decode step {ms:.2f} ms on the grid (the slowest rank, "
                f"median of steps 2-{SERVE_GRID_STEPS}) against "
                f"{one_ms:.2f} ms in one process, host ms in the "
                f"collectives by rank {host}; rank 0's calls a step "
                f"{calls}; prefill {pre_ms:.1f} ms against "
                f"{one['prefill_s'] * 1e3:.1f} ms, its calls {pre_calls}")
            torch.cuda.ipc_collect()
        del params, one
        torch.cuda.empty_cache()
    stats["grid_17a"] = rec


def grid_serve_engine(world, gates, dev, seed: int, stats) -> None:
    """17b: the engine on SERVE_GRID at the full 28 layers in bf16,
    against the same grid's stepwise greedy oracle (prefill + decode_step
    as the engine calls them); each rank's parameter and cache bytes
    against ``decode_specs(..., grid=)``'s."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import inputs as I
    from repro_torch.launch.grid_serve import grid_engine, grid_oracle
    from repro_torch.models import api
    from repro_torch.models.module import param_bytes
    from repro_torch.serve import ServeConfig
    layers = get_config("llama3_2_3b").n_layers
    cfg, params = serve_grid_params(layers, torch.bfloat16, dev, seed)
    gen = np.random.default_rng(seed + 18)
    prompts = [list(map(int, gen.integers(1, cfg.vocab,
                                          size=SERVE_ENGINE_PROMPT)))
               for _ in range(SERVE_ENGINE_PROMPTS)]
    sc = ServeConfig(max_seq=SERVE_ENGINE_MAX_SEQ,
                     slots=SERVE_ENGINE_PROMPTS, min_bucket=32)
    recs = grid_engine(world, SERVE_GRID, cfg, params, prompts,
                       SERVE_ENGINE_NEW, sc)
    torch.cuda.ipc_collect()
    oracle = grid_oracle(world, SERVE_GRID, cfg, params, prompts,
                         SERVE_ENGINE_NEW, sc)
    torch.cuda.ipc_collect()
    shape = ShapeConfig("serve", SERVE_ENGINE_MAX_SEQ, SERVE_ENGINE_PROMPTS,
                        "decode")
    p_specs, c_specs, _, _ = I.decode_specs(cfg, shape, grid=SERVE_GRID)
    want_p, want_c = I.tree_bytes(p_specs), I.tree_bytes(c_specs)
    outs = recs[0]["outs"]
    same = all(r["outs"] == oracle["outs"] for r in recs)
    sized = all(r["param_bytes"] == want_p and r["cache_bytes"] == want_c
                for r in recs)
    gen_s = max(r["generate_s"] for r in recs)
    ntok = sum(len(o) for o in outs)
    step_ms = max(float(np.median(s[1:])) for s in oracle["step_s"]) * 1e3
    prefill_ms = max(max(s) for s in oracle["prefill_s"]) * 1e3
    whole_bytes = param_bytes(api.param_specs(cfg))
    # the card holds the four ranks: each weight is cut over 'model' and
    # read by both rows, so a step reads 2 x the weights and the caches
    card_bound = (len(recs) * (want_p + want_c)) / HBM_BYTES_PER_S * 1e3
    rank_bound = (want_p + want_c) / HBM_BYTES_PER_S * 1e3
    peaks = [round((r["peak_bytes"] or 0) / 1e9, 2) for r in recs]
    stats["grid_17b"] = {
        "tokens": outs, "oracle_equal": same, "bytes_equal": sized,
        "param_bytes": want_p, "cache_bytes": want_c,
        "whole_param_bytes": whole_bytes, "generate_s": gen_s,
        "tok_s": ntok / gen_s, "step_ms": step_ms, "prefill_ms": prefill_ms,
        "card_bound_ms": card_bound, "rank_bound_ms": rank_bound,
        "peak_gb": peaks}
    gates.check(
        "17b bf16 engine on (2, 2) == the grid's stepwise greedy oracle",
        same and sized and oracle["finite"] and all(
            len(o) == SERVE_ENGINE_NEW for o in outs),
        f"{card()}; {layers} layers bf16, {SERVE_ENGINE_PROMPTS} requests of "
        f"{SERVE_ENGINE_PROMPT} tokens, {SERVE_ENGINE_NEW} new each, two "
        f"slots a row: tokens {outs} equal to the oracle's {same}; logits "
        f"finite {oracle['finite']}; a rank's parameters {want_p / 1e9:.3f} "
        f"GB (whole {whole_bytes / 1e9:.3f}) and cache {want_c / 1e6:.2f} MB"
        f", decode_specs' on every rank {sized}; generate {gen_s:.2f} s "
        f"({ntok / gen_s:.1f} tok/s); the oracle's prefill {prefill_ms:.1f} "
        f"ms a request, decode {step_ms:.2f} ms a step (the slowest rank, "
        f"median of steps 2-{SERVE_ENGINE_NEW}) against the card's read "
        f"bound {card_bound:.3f} ms (four ranks' blocks; a rank's "
        f"{rank_bound:.3f} ms alone); peaks GB by rank {peaks}")
    del params
    torch.cuda.empty_cache()


def grid_serve_phase(seed: int, stats: dict, dev=None, world=None) -> dict:
    """Phase 17: serving on a (2, 2) grid of gloo ranks sharing the card
    (plain torch and collectives: the returned launch counts are all
    zero), on ``world`` when given (phase 14's: its caller closes it).
    Raises at the end if any gate failed."""
    dev = torch.device("cuda") if dev is None else dev
    gates = Gates()
    gk.reset_launch_counts()
    own = world is None
    world = spawn_world(dev, GRID_RANKS) if own else world
    try:
        for name, fn in (
                ("17a", lambda: grid_serve_exactness(world, gates, dev, seed,
                                                     stats)),
                ("17b", lambda: grid_serve_engine(world, gates, dev, seed,
                                                  stats))):
            _, secs = timed(fn)
            stats[f"phase{name}_s"] = secs
            log(f"  {name} took {secs:.1f} s")
            torch.cuda.ipc_collect()
            torch.cuda.empty_cache()
    finally:
        if own:
            world.close()
    counts = launches()
    if gates.failed:
        raise AssertionError(f"phase 17 gates failed: {gates.failed}")
    return counts


# ---------------------------------------------------------------------------
# Phase 18: the encoder-decoder and the vlm on a grid of ranks
# ---------------------------------------------------------------------------
# Phase 14's four gloo ranks sharing the card, laid out (2, 2): tensor
# parallelism over 'model' of seamless-m4t-large-v2's encoder, decoder and
# cross-attention and of llava-next-34b's decoder behind its 2880-patch
# prefix, ZeRO-1 over 'data'; both at their published widths, random
# weights from --seed at fan-in (attention_fan_in, as 16b / 17a: the
# reference's init makes f32's rounding chaotic with depth), the frames and
# patches N(0, 0.02^2) from --seed (train.trainer.frontend_embeds).  Cuts,
# and why (a one-process run and the ranks' blocks share the card, and the
# phase's seconds are paid by cuts of earlier phases): 18a trains seamless
# at FAMILY_TRAIN_LAYERS + as many encoder layers of 24 + 24 (its
# 256256-row embedding and lm_head are 1.05 GB of f32 each), its f64 twin
# at FAMILY_F64_LAYERS; 18b serves it at FAMILY_SERVE_LAYERS (f32) and
# FAMILY_F64_LAYERS (f64) against one process, then bf16 at all 24 + 24;
# 18c holds llava at FAMILY_SERVE_LAYERS (f32) / FAMILY_F64_LAYERS (f64) of
# 60 against one process (a layer is 558 M parameters, the untied
# embeddings 918 M: 8.1 / 11.8 GB whole), trains LLAVA_TRAIN_LAYERS layer
# on the ranks laid out LLAVA_TRAIN_GRID, and times bf16 at
# LLAVA_BF16_LAYERS of 60.  Why (1, 4) for llava's step: its f32 state on
# (2, 2) (a rank's 2.96 GB of weights, as much gradient, 4.4 GB of ZeRO-1
# state and the gradient all-reduce's two 2.96 GB buffers) beside the one
# process's weights and result (17.7 GB) ran the card out of memory, and
# with FSDP over 'data' to fit, the step's host-staged gathers and
# reduce-scatters took 28 s of the part's 68 (the first card runs); on
# (1, 4) every rank is on 'model' (56 / 8 heads, d_ff 20480 and vocab
# 64000 divide 4) and nothing crosses 'data'; every rank takes every row,
# and at 4 rows of 3008 positions a rank's step (7.4 GB of state, the
# chunked attention's saved blocks recomputed in backward) ran the card
# out of memory again, so LLAVA_TRAIN_BATCH is 2 rows.
# The vlm's ZeRO-1 and FSDP on (2, 2) are held on the CPU
# (tests/test_torch_grid_families.py).  Prompts: four rows of
# FAMILY_PROMPT tokens (lengths SERVE_GRID_LENS, right-padded), seamless's
# with cross_frames(FAMILY_MAX_SEQ) = 128 frames a row, llava's after its
# prefix (positions 2880 on).
FAMILY_GRID = (2, 2)
FAMILY_TRAIN_LAYERS = 2
FAMILY_F64_LAYERS = 1
FAMILY_SERVE_LAYERS = 2
FAMILY_TRAIN_BATCH = (4, 256)   # rows x tokens; seamless's 128 frames a row
LLAVA_TRAIN_LAYERS = 1
LLAVA_TRAIN_GRID = (1, 4)
LLAVA_TRAIN_BATCH = (2, 128)    # text tokens after the 2880 patches
LLAVA_BF16_LAYERS = 8
FAMILY_PROMPT = 64
FAMILY_MAX_SEQ = 128            # seamless's; llava's adds its prefix
FAMILY_STEPS = 8
FAMILY_BF16_STEPS = 4           # the bf16 timing's decode steps


def family_cfg(arch: str, layers: int, dtype, **kw):
    """``arch`` at its published width cut to ``layers`` decoder (and as
    many encoder) layers, in ``dtype``."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    depth = {"n_layers": layers}
    if cfg.family == "audio":
        depth["enc_layers"] = layers
    return dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype,
                               **depth, **kw)


def family_params(cfg, dev, seed: int) -> dict:
    """Random weights of ``cfg`` from ``seed`` at fan-in."""
    from repro_torch.models import api
    from repro_torch.models.module import init_params
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(api.param_specs(cfg), gen, dev)
    attention_fan_in(params, cfg)
    return params


def family_prompts(cfg, dev, seed: int) -> tuple:
    """(tokens, lens, embeds, max_seq): four prompts of FAMILY_PROMPT
    tokens (SERVE_GRID_LENS real), the family's frontend embeddings a row
    (seamless's api.cross_frames(FAMILY_MAX_SEQ) frames), and the cache's
    positions (llava's count its prefix)."""
    from repro_torch.train.trainer import frontend_embeds
    gen = torch.Generator(device=dev).manual_seed(seed + 18)
    B = len(SERVE_GRID_LENS)
    tokens = torch.randint(0, cfg.vocab, (B, FAMILY_PROMPT), generator=gen,
                           device=dev)
    lens = torch.tensor(SERVE_GRID_LENS, device=dev)
    tokens[torch.arange(FAMILY_PROMPT, device=dev)[None, :]
           >= lens[:, None]] = 0
    max_seq = FAMILY_MAX_SEQ        # the audio family's frames: its cross
    (emb,) = frontend_embeds(cfg, B, max_seq, seed, 0).values()
    if cfg.family == "vlm":
        max_seq += cfg.frontend_tokens
    return tokens, lens, torch.from_numpy(emb).to(dev, cfg.dtype), max_seq


def family_serve_exactness(world, gates, dev, seed: int, arch: str,
                           tag: str) -> dict:
    """18b / 18c: prefill and FAMILY_STEPS decode steps on FAMILY_GRID
    under both cache layouts against one process on the same weights (fed
    the one process's tokens), f32 at FAMILY_SERVE_LAYERS layers and f64
    at FAMILY_F64_LAYERS."""
    from repro_torch.launch.grid_serve import grid_serve, one_process_serve
    rec = {}
    for dt, layers, dtype, tol in (
            ("f32", FAMILY_SERVE_LAYERS, torch.float32, SERVE_GRID_TOL),
            ("f64", FAMILY_F64_LAYERS, torch.float64, SERVE_GRID_F64_TOL)):
        cfg = family_cfg(arch, layers, dtype)
        params = family_params(cfg, dev, seed)
        tokens, lens, embeds, max_seq = family_prompts(cfg, dev, seed)
        one = one_process_serve(cfg, params, tokens, lens, max_seq,
                                FAMILY_STEPS, embeds=embeds)
        one_ms = float(np.median(one["step_s"][1:])) * 1e3
        for seq in (True, False):
            name = f"{dt} {'cache_seq' if seq else 'kv heads'}"
            got = grid_serve(world, FAMILY_GRID, cfg, params, tokens, lens,
                             max_seq, FAMILY_STEPS, feed=one["fed"].to(dev),
                             seq_shard=seq, embeds=embeds)
            errs = step_errors(got["logits"], one["logits"])
            same = torch.equal(got["picks"], one["picks"])
            ms = max(float(np.median(s[1:])) for s in got["step_s"]) * 1e3
            pre_ms = max(got["prefill_s"]) * 1e3
            host = [round(h * 1e3, 2) for h in got["host_s"]]
            calls = calls_by_group(got["calls"][0])
            pre_calls = calls_by_group(got["prefill_calls"][0])
            shapes = got["cache_shapes"][0]
            rec[name] = {"errs": errs, "tokens_equal": same, "step_ms": ms,
                         "one_process_step_ms": one_ms, "prefill_ms": pre_ms,
                         "one_process_prefill_ms": one["prefill_s"] * 1e3,
                         "host_ms": host, "calls_rank0": calls,
                         "prefill_calls_rank0": pre_calls,
                         "cache_shapes": shapes}
            gates.check(
                f"{tag} {cfg.name} {name} (2, 2) == one process",
                max(errs) <= tol and same,
                f"{card()}; {layers} layers {dt}: prefill + {FAMILY_STEPS} "
                f"decode steps, worst step's logits {max(errs):.2e} of their "
                f"norm (tol {tol:g}); greedy tokens equal {same}; rank 0's "
                f"cache block {shapes}; a decode step {ms:.2f} ms on the "
                f"grid (the slowest rank, median of steps 2-{FAMILY_STEPS}) "
                f"against {one_ms:.2f} ms in one process, host ms in the "
                f"collectives by rank {host}; rank 0's calls a step {calls}; "
                f"prefill {pre_ms:.1f} ms against "
                f"{one['prefill_s'] * 1e3:.1f} ms, its calls {pre_calls}")
            del got
            torch.cuda.ipc_collect()
        del params, one, embeds
        torch.cuda.empty_cache()
    return rec


def grid_read_bound_ms(cfg, p_specs, c_specs, ranks: int) -> tuple:
    """The card's least time for one decode step of ``ranks`` ranks on it,
    each reading its parameter blocks that a step reads (not the encoder,
    nor the cross-attention's k / v projections, whose outputs the cache
    holds; of untied embeddings only a row) and its cache block once:
    (ms, a rank's weight bytes read, its cache bytes)."""
    from repro_torch.launch import inputs as I
    skip = {"encoder", "enc_norm"} | (
        set() if cfg.tie_embeddings else {"embedding"})
    read = {k: v for k, v in p_specs.items() if k not in skip}
    if "decoder" in read:
        cross = {k: v for k, v in read["decoder"]["cross"].items()
                 if k not in ("wk", "wv", "bk", "bv")}
        read["decoder"] = dict(read["decoder"], cross=cross)
    weights = I.tree_bytes(read)
    cache = I.tree_bytes(c_specs)
    return (ranks * (weights + cache) / HBM_BYTES_PER_S * 1e3, weights,
            cache)


def family_serve_timing(world, gates, dev, seed: int, arch: str, tag: str,
                        layers: int) -> dict:
    """18b / 18c: bf16 prefill and FAMILY_BF16_STEPS greedy decode steps on
    FAMILY_GRID (the cache's positions over 'model'): ms a step beside
    the card's read bound, tok/s, finite logits, each rank's parameter
    and cache bytes against ``decode_specs(..., grid=)``'s."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import inputs as I
    from repro_torch.launch.grid_serve import grid_serve
    cfg = family_cfg(arch, layers, torch.bfloat16)
    params = family_params(cfg, dev, seed)
    tokens, lens, embeds, max_seq = family_prompts(cfg, dev, seed)
    got = grid_serve(world, FAMILY_GRID, cfg, params, tokens, lens, max_seq,
                     FAMILY_BF16_STEPS, embeds=embeds)
    B = tokens.shape[0]
    shape = ShapeConfig("serve", max_seq, B, "decode")
    p_specs, c_specs, _, _ = I.decode_specs(cfg, shape, grid=FAMILY_GRID)
    want_p, want_c = I.tree_bytes(p_specs), I.tree_bytes(c_specs)
    sized = all(p == want_p and c == want_c for p, c in
                zip(got["param_bytes"], got["cache_bytes"]))
    finite = bool(torch.isfinite(got["logits"]).all())
    ms = max(float(np.median(s[1:])) for s in got["step_s"]) * 1e3
    pre_ms = max(got["prefill_s"]) * 1e3
    bound, read_w, read_c = grid_read_bound_ms(cfg, p_specs, c_specs,
                                               len(got["step_s"]))
    steps_s = max(sum(s) for s in got["step_s"])
    tok_s = B * FAMILY_BF16_STEPS / steps_s
    peaks = [round((b or 0) / 1e9, 2) for b in got["peak_bytes"]]
    calls = calls_by_group(got["calls"][0])
    rec = {"layers": layers, "step_ms": ms, "prefill_ms": pre_ms,
           "bound_ms": bound, "read_weight_bytes": read_w,
           "cache_bytes": want_c, "param_bytes": want_p,
           "bytes_equal": sized, "finite": finite, "tok_s": tok_s,
           "peak_gb": peaks, "calls_rank0": calls,
           "host_ms": [round(h * 1e3, 2) for h in got["host_s"]]}
    gates.check(
        f"{tag} {cfg.name} bf16 on (2, 2): finite, decode_specs' bytes",
        finite and sized,
        f"{card()}; {layers} layers bf16, {B} prompts of {FAMILY_PROMPT} "
        f"tokens into {max_seq} positions, {FAMILY_BF16_STEPS} greedy steps: "
        f"logits finite {finite}; a rank's parameters {want_p / 1e9:.3f} "
        f"GB and cache {want_c / 1e6:.2f} MB, decode_specs' on every rank "
        f"{sized}; prefill {pre_ms:.1f} ms; decode {ms:.2f} ms a step (the "
        f"slowest rank, median of steps 2-{FAMILY_BF16_STEPS}) against the "
        f"card's read bound {bound:.3f} ms (four ranks each reading "
        f"{read_w / 1e9:.3f} GB of weights and its cache); {tok_s:.1f} "
        f"tok/s over the decode steps; rank 0's calls a step {calls}; "
        f"peaks GB by rank {peaks}")
    del params, got
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    return rec


def seamless_grid_train(world, gates, dev, seed: int, stats) -> None:
    """18a: one train step of seamless at FAMILY_TRAIN_LAYERS + as many
    encoder layers on (2, 2) against one process at 15c's gates, the f64
    twin's loss at GRID_F64_TOL."""
    arch = "seamless_m4t_large_v2"
    cfg = family_cfg(arch, FAMILY_TRAIN_LAYERS, torch.float32)
    cfg64 = family_cfg(arch, FAMILY_F64_LAYERS, torch.float64)
    one = grid_one_process(cfg, dev, seed, FAMILY_TRAIN_BATCH)
    one64 = grid_one_process(cfg64, dev, seed, FAMILY_TRAIN_BATCH)
    grid_step_check(world, gates, stats, "18a", cfg, one, cfg64, one64,
                    f"{FAMILY_TRAIN_LAYERS} + {FAMILY_TRAIN_LAYERS} layers",
                    f"{FAMILY_F64_LAYERS} + {FAMILY_F64_LAYERS}")
    del one, one64
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()


def llava_grid_train(world, gates, dev, seed: int, stats) -> None:
    """18c: one train step of llava at LLAVA_TRAIN_LAYERS layer on
    LLAVA_TRAIN_GRID against one process at 15c's gates (the phase
    comment says why on that grid)."""
    cfg = family_cfg("llava_next_34b", LLAVA_TRAIN_LAYERS, torch.float32)
    one = grid_one_process(cfg, dev, seed, LLAVA_TRAIN_BATCH)
    grid_step_check(world, gates, stats, "18c train", cfg, one,
                    depth=f"{LLAVA_TRAIN_LAYERS} layer",
                    grid=LLAVA_TRAIN_GRID)
    del one
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()


def family_grid_phase(seed: int, stats: dict, dev=None, world=None) -> dict:
    """Phase 18: seamless and llava trained and served on a (2, 2) grid
    of gloo ranks sharing the card (plain torch and collectives: the
    returned launch counts are all zero), on ``world`` when given (phase
    14's: its caller closes it).  Raises at the end if any gate failed."""
    from repro_torch.configs import get_config
    dev = torch.device("cuda") if dev is None else dev
    gates = Gates()
    gk.reset_launch_counts()
    own = world is None
    world = spawn_world(dev, GRID_RANKS) if own else world
    def serve(tag, arch, bf16_layers):
        stats[f"grid_{tag}"] = {
            "exact": family_serve_exactness(world, gates, dev, seed, arch,
                                            tag),
            "bf16": family_serve_timing(world, gates, dev, seed, arch, tag,
                                        bf16_layers)}
    try:
        for name, fn in (
                ("18a", lambda: seamless_grid_train(world, gates, dev, seed,
                                                    stats)),
                ("18b", lambda: serve("18b", "seamless_m4t_large_v2",
                                      get_config("seamless_m4t_large_v2")
                                      .n_layers)),
                ("18c serve", lambda: serve("18c", "llava_next_34b",
                                            LLAVA_BF16_LAYERS)),
                ("18c train", lambda: llava_grid_train(world, gates, dev,
                                                       seed, stats))):
            _, secs = timed(fn)
            stats[f"phase{name.replace(' ', '_')}_s"] = secs
            log(f"  {name} took {secs:.1f} s")
            release_ranks(world)
    finally:
        if own:
            world.close()
    counts = launches()
    if gates.failed:
        raise AssertionError(f"phase 18 gates failed: {gates.failed}")
    return counts


# ---------------------------------------------------------------------------
# Phase 19: the ssm family on a grid of ranks
# ---------------------------------------------------------------------------
# Phase 14's four gloo ranks sharing the card, laid out (2, 2): mamba's
# "inner" over 'model' (wz / wx / conv_x / norm by d_inner's channels, out
# by its rows, wdt / A_log / D / dt_bias by its 32 heads; wB / wC /
# conv_B / conv_C whole), the vocab over 'model', ZeRO-1 over 'data', at
# mamba2-370m's published width (d_model 1024, d_inner 2048, 32 heads of
# 64, d_state 128, vocab 50432 padded), random weights from --seed as
# init_params draws them (no attention, so no fan-in rescale).  Cuts, and
# why (the phase is paid for within the script's limit; a host-staged
# collective costs 4-6 ms, and a layer takes two a decode step): 19a
# steps SSM_TRAIN_LAYERS of 48 layers in f32 (its f64 twin at
# SSM_F64_LAYERS) on SSM_TRAIN_ROWS rows of two SSD chunks; 19b serves
# SSM_SERVE_LAYERS (f32) and SSM_F64_LAYERS (f64) against one process;
# 19c serves all 48 layers in bf16 through the engine.  f64 models keep
# the reference's f32 islands (dt, B, C, the scan and its state), which
# the grid rounds otherwise than one process where the card's f32
# products change shape with the rank's heads and rows: 19b holds f64
# logits at SSM_SERVE_F64_TOL, f32's gate (read on an H100: 5.90e-6 at
# 1 layer, f32 8.70e-6 at 2; tests/test_torch_grid_ssm.py reads 1.7e-7
# on the CPU), and 19a the f64 loss at SSM_F64_LOSS_TOL (read 1.5e-9).
SSM_GRID = (2, 2)
SSM_TRAIN_LAYERS = 2
SSM_F64_LAYERS = 1
SSM_SERVE_LAYERS = 2
SSM_TRAIN_ROWS = 4              # of 2 SSD chunks (512 tokens) each
SSM_LOSS_TOL = 1e-6             # relative, f32
SSM_F64_LOSS_TOL = 1e-8
SSM_SERVE_F64_TOL = SERVE_GRID_TOL  # the f32 islands' spread
SSM_GRID_PROMPTS = 4            # of one SSD chunk (256 tokens) each
SSM_STEPS = 8
SSM_ENGINE_NEW = 8
SSM_MAX_SEQ = 512


def ssm_cfg(layers: int, dtype):
    """mamba2-370m at its published width cut to ``layers``, in
    ``dtype``."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mamba2_370m"), n_layers=layers,
                               dtype=dtype, param_dtype=dtype)


def ssm_grid_prompts(cfg, dev, seed: int) -> tuple:
    """(tokens, lens): SSM_GRID_PROMPTS prompts of one SSD chunk, every
    token real (a recurrence is not mask-protected)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    S = cfg.ssm.chunk
    tokens = torch.randint(0, cfg.vocab, (SSM_GRID_PROMPTS, S),
                           generator=gen, device=dev)
    return tokens, torch.full((SSM_GRID_PROMPTS,), S, device=dev)


def ssm_grid_train(world, gates, dev, seed: int, stats) -> None:
    """19a: one train step on SSM_GRID against one process (f32 at
    SSM_TRAIN_LAYERS, f64 at SSM_F64_LAYERS)."""
    from repro_torch.launch.grid_train import grid_train_steps
    cfg = ssm_cfg(SSM_TRAIN_LAYERS, torch.float32)
    shape = (SSM_TRAIN_ROWS, 2 * cfg.ssm.chunk)
    params, batch, m1, want, one_ms = grid_one_process(cfg, dev, seed, shape)
    got = grid_train_steps(world, SSM_GRID, cfg, params, batch, keep=False,
                           want=want)
    del params, batch, want
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    cfg64 = ssm_cfg(SSM_F64_LAYERS, torch.float64)
    p64, b64, m64, _, one64_ms = grid_one_process(cfg64, dev, seed, shape)
    g64 = grid_train_steps(world, SSM_GRID, cfg64, p64, b64, keep=False)
    del p64, b64
    tm = got["first"]
    rel_ = {k: abs(tm[k] - m1[k]) / abs(m1[k]) for k in ("loss", "grad_norm")}
    rel64 = {k: abs(g64["first"][k] - m64[k]) / abs(m64[k])
             for k in ("loss", "grad_norm")}
    worst = {k: max(((n, e) for n, e in got["err"].items()
                     if n.startswith(k + "/")), key=lambda kv: kv[1])
             for k in ("master", "m")}
    ms = max(s[-1] for s in got["step_s"]) * 1e3
    share = [round(h / s[-1], 3) for h, s in zip(got["host_s"],
                                                  got["step_s"])]
    peaks = [round((b or 0) / 1e9, 2) for b in got["peak_bytes"]]
    kinds = {k: (v["all_reduces"], v["all_gathers"], v["reduce_scatters"])
             for k, v in got["counters"][0].items()}
    stats["grid_19a"] = {"rel": rel_, "rel64": rel64, "worst": worst,
                         "still": got["still"], "ms": ms,
                         "one_process_ms": one_ms,
                         "f64_ms": max(s[-1] for s in g64["step_s"]) * 1e3,
                         "one_process_f64_ms": one64_ms,
                         "collective_share": share, "peak_gb": peaks,
                         "calls_rank0": kinds}
    gates.check(
        f"19a {cfg.name} train step on {SSM_GRID} == one process",
        rel_["loss"] <= SSM_LOSS_TOL
        and rel_["grad_norm"] <= GRID_TOL["grad_norm"]
        and worst["m"][1] <= GRID_TOL["m"]
        and worst["master"][1] <= GRID_TOL["master"]
        and not got["still"] and rel64["loss"] <= SSM_F64_LOSS_TOL,
        f"{card()}; {SSM_TRAIN_LAYERS} layers f32, {shape[0]} x {shape[1]} "
        f"tokens, one step at lr 1e-3 (no warmup): loss {tm['loss']:.6f} "
        f"(rel {rel_['loss']:.1e}, tol {SSM_LOSS_TOL:g}), grad norm "
        f"{tm['grad_norm']:.4f} (rel {rel_['grad_norm']:.1e}), worst master "
        f"move {worst['master'][0]} {worst['master'][1]:.2e}, worst m "
        f"{worst['m'][0]} {worst['m'][1]:.2e}; master blocks that did not "
        f"move {got['still']}; f64 at {SSM_F64_LAYERS} layer: loss rel "
        f"{rel64['loss']:.1e} (tol {SSM_F64_LOSS_TOL:g}), grad norm rel "
        f"{rel64['grad_norm']:.1e}; the step {ms:.1f} ms on the grid (the "
        f"slowest rank) against {one_ms:.1f} ms in one process (each the "
        f"first), the share of it in the collectives by rank {share}; rank "
        f"0's (all-reduce, all-gather, reduce-scatter) calls by group "
        f"{kinds}; peaks {peaks} GB a rank")


def ssm_grid_serve(world, gates, dev, seed: int, stats) -> None:
    """19b: prefill and SSM_STEPS decode steps on SSM_GRID under both
    cache layouts (the same bits: the ssm cache has no positions) against
    one process, f32 at SSM_SERVE_LAYERS and f64 at SSM_F64_LAYERS; the
    collectives of prefill and of a decode step."""
    from repro_torch.launch.grid_serve import grid_serve, one_process_serve
    rec = {}
    for dt, layers, dtype, tol in (
            ("f32", SSM_SERVE_LAYERS, torch.float32, SERVE_GRID_TOL),
            ("f64", SSM_F64_LAYERS, torch.float64, SSM_SERVE_F64_TOL)):
        cfg = ssm_cfg(layers, dtype)
        params = family_params(cfg, dev, seed)
        tokens, lens = ssm_grid_prompts(cfg, dev, seed)
        one = one_process_serve(cfg, params, tokens, lens, SSM_MAX_SEQ,
                                SSM_STEPS)
        one_ms = float(np.median(one["step_s"][1:])) * 1e3
        runs = {seq: grid_serve(world, SSM_GRID, cfg, params, tokens, lens,
                                SSM_MAX_SEQ, SSM_STEPS,
                                feed=one["fed"].to(dev), seq_shard=seq)
                for seq in (True, False)}
        got = runs[True]
        same_bits = (torch.equal(got["logits"], runs[False]["logits"])
                     and torch.equal(got["picks"], runs[False]["picks"]))
        errs = step_errors(got["logits"], one["logits"])
        same = torch.equal(got["picks"], one["picks"])
        ms = max(float(np.median(s[1:])) for s in got["step_s"]) * 1e3
        pre_ms = max(got["prefill_s"]) * 1e3
        calls = calls_by_group(got["calls"][0])
        pre_calls = calls_by_group(got["prefill_calls"][0])
        want = {"model": {"all_reduce": 1 + 2 * layers}}
        rec[dt] = {"errs": errs, "tokens_equal": same,
                   "layouts_same_bits": same_bits, "step_ms": ms,
                   "one_process_step_ms": one_ms, "prefill_ms": pre_ms,
                   "one_process_prefill_ms": one["prefill_s"] * 1e3,
                   "host_ms": [round(h * 1e3, 2) for h in got["host_s"]],
                   "calls_rank0": calls, "prefill_calls_rank0": pre_calls,
                   "cache_shapes": got["cache_shapes"][0]}
        gates.check(
            f"19b {cfg.name} {dt} (2, 2) == one process",
            max(errs) <= tol and same and same_bits and calls == want
            and pre_calls == want,
            f"{card()}; {layers} layers {dt}: prefill + {SSM_STEPS} decode "
            f"steps, worst step's logits {max(errs):.2e} of their norm (tol "
            f"{tol:g}); greedy tokens equal {same}; cache_seq and kv-head "
            f"layouts the same bits {same_bits}; rank 0's cache block "
            f"{got['cache_shapes'][0]}; a decode step {ms:.2f} ms on the "
            f"grid (the slowest rank, median of steps 2-{SSM_STEPS}) against "
            f"{one_ms:.2f} ms in one process; rank 0's calls a step {calls} "
            f"and in prefill {pre_calls} (predicted {want}); prefill "
            f"{pre_ms:.1f} ms against {one['prefill_s'] * 1e3:.1f} ms")
        del params, one, runs, got
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
    stats["grid_19b"] = rec


def ssm_grid_engine(world, gates, dev, seed: int, stats) -> None:
    """19c: the bf16 engine on SSM_GRID at all 48 layers, two slots a row,
    against the grid's stepwise greedy oracle; ms a decode step, tok/s,
    a decode call's collectives, each rank's bytes against
    ``decode_specs(..., grid=)``'s, the card's read bound."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import inputs as I
    from repro_torch.launch.grid_serve import grid_engine, grid_oracle
    from repro_torch.serve import ServeConfig
    layers = get_config("mamba2_370m").n_layers
    cfg = ssm_cfg(layers, torch.bfloat16)
    params = family_params(cfg, dev, seed)
    tokens, _ = ssm_grid_prompts(cfg, dev, seed)
    prompts = [list(map(int, t)) for t in tokens.tolist()]
    sc = ServeConfig(max_seq=SSM_MAX_SEQ, slots=SSM_GRID_PROMPTS)
    recs = grid_engine(world, SSM_GRID, cfg, params, prompts,
                       SSM_ENGINE_NEW, sc)
    torch.cuda.ipc_collect()
    oracle = grid_oracle(world, SSM_GRID, cfg, params, prompts,
                         SSM_ENGINE_NEW, sc)
    torch.cuda.ipc_collect()
    shape = ShapeConfig("serve", SSM_MAX_SEQ, SSM_GRID_PROMPTS, "decode")
    p_specs, c_specs, _, _ = I.decode_specs(cfg, shape, grid=SSM_GRID)
    want_p, want_c = I.tree_bytes(p_specs), I.tree_bytes(c_specs)
    bound, read_w, read_c = grid_read_bound_ms(cfg, p_specs, c_specs,
                                               len(recs))
    ssm = c_specs["blocks"]["sub0"]["ssm"]
    counted = (read_w == want_p and read_c == want_c
               and ssm.dtype == torch.float32
               and "mamba" in p_specs["blocks"]["sub0"])
    outs = recs[0]["outs"]
    same = all(r["outs"] == oracle["outs"] for r in recs)
    sized = all(r["param_bytes"] == want_p and r["cache_bytes"] == want_c
                for r in recs)
    gen_s = max(r["generate_s"] for r in recs)
    ntok = sum(len(o) for o in outs)
    step_ms = max(float(np.median(s[1:])) for s in oracle["step_s"]) * 1e3
    prefill_ms = max(max(s) for s in oracle["prefill_s"]) * 1e3
    calls = calls_by_group(oracle["calls"][0])
    peaks = [round((r["peak_bytes"] or 0) / 1e9, 2) for r in recs]
    stats["grid_19c"] = {
        "tokens": outs, "oracle_equal": same, "bytes_equal": sized,
        "param_bytes": want_p, "cache_bytes": want_c,
        "ssm_state_bytes": I.tree_bytes({"ssm": ssm}),
        "generate_s": gen_s, "tok_s": ntok / gen_s, "step_ms": step_ms,
        "prefill_ms": prefill_ms, "bound_ms": bound,
        "read_counts_mamba_and_f32_state": counted, "calls_rank0": calls,
        "peak_gb": peaks}
    gates.check(
        "19c bf16 engine on (2, 2) == the grid's stepwise greedy oracle",
        same and sized and counted and oracle["finite"] and all(
            len(o) == SSM_ENGINE_NEW for o in outs),
        f"{card()}; {layers} layers bf16, {SSM_GRID_PROMPTS} requests of "
        f"{cfg.ssm.chunk} tokens, {SSM_ENGINE_NEW} new each (the first from "
        f"the prefill), two slots a row: tokens {outs} equal to the "
        f"oracle's {same}; logits finite {oracle['finite']}; a rank's "
        f"parameters {want_p / 1e9:.3f} GB and cache {want_c / 1e6:.2f} MB "
        f"(the f32 ssm state {I.tree_bytes({'ssm': ssm}) / 1e6:.2f} MB), "
        f"decode_specs' on every rank {sized}; generate {gen_s:.2f} s "
        f"({ntok / gen_s:.1f} tok/s); the oracle's prefill {prefill_ms:.1f} "
        f"ms a request, decode {step_ms:.2f} ms a step (the slowest rank, "
        f"median of steps 2-{SSM_ENGINE_NEW - 1}, with the greedy "
        f"all-gather) against the card's read bound {bound:.3f} ms (four "
        f"ranks each reading {read_w / 1e9:.3f} GB of weights and "
        f"{read_c / 1e6:.2f} MB of cache: mamba leaves and f32 state "
        f"counted {counted}); rank 0's calls a decode call {calls}; peaks "
        f"GB by rank {peaks}")
    del params
    torch.cuda.empty_cache()


def ssm_grid_phase(seed: int, stats: dict, dev=None, world=None) -> dict:
    """Phase 19: mamba2-370m trained and served on a (2, 2) grid of gloo
    ranks sharing the card (plain torch and collectives: the returned
    launch counts are all zero), on ``world`` when given (phase 14's: its
    caller closes it).  Raises at the end if any gate failed."""
    dev = torch.device("cuda") if dev is None else dev
    gates = Gates()
    gk.reset_launch_counts()
    own = world is None
    world = spawn_world(dev, GRID_RANKS) if own else world
    try:
        for name, fn in (
                ("19a", lambda: ssm_grid_train(world, gates, dev, seed,
                                               stats)),
                ("19b", lambda: ssm_grid_serve(world, gates, dev, seed,
                                               stats)),
                ("19c", lambda: ssm_grid_engine(world, gates, dev, seed,
                                                stats))):
            _, secs = timed(fn)
            stats[f"phase{name}_s"] = secs
            log(f"  {name} took {secs:.1f} s")
            release_ranks(world)
    finally:
        if own:
            world.close()
    counts = launches()
    if gates.failed:
        raise AssertionError(f"phase 19 gates failed: {gates.failed}")
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=1024,
                    help="inner iterations of each real-sim solve")
    ap.add_argument("--reps", type=int, default=50,
                    help="calls per kernel timing")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--parent", default=None,
                    help="a checkout of another commit: its bf16 packets "
                         "timed at the run's start and end, in turns with "
                         "phase 2c's")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = card()

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

    parent_before = None
    if args.parent:     # before this process's first profiler trace
        parent_before, secs = timed(lambda: parent_bf16_times(
            args.parent, args.seed, args.reps))
        log(f"  the parent design's bf16 packets at {args.parent}: "
            f"{parent_before} ({secs:.1f} s with its build)")

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
    # sb at s = 16 for the packets and matvecs, b for the applies; the
    # packets and matvecs also at m = 8 (s = 1, 1024 of the single solves'
    # 1088 packets), the matvecs with the batched engine's 8 tenants.
    main_m = {"packet": (128, 8), "apply": (8,), "matvec": (128, 8)}
    paths = {}
    flush = l2_flush(dev)
    records = check_kernels(X, gen, "f32", (8, 128, 77), args.reps, main_m,
                            TENANTS, flush)
    records.update(check_dense_kernels(X, gen, "f32", (8, 128, 77),
                                       args.reps, 128))
    records.update(check_cg_shape(X, gen, max(1, args.reps // 5), flush))
    del flush
    log("== 2c. bf16 packets K1 / K3 / K7 on the real-sim X cast to bf16")
    bf16_recs, paths["bf16 packets"] = check_bf16_packets(
        X, args.seed, args.reps, parent_before is not None)
    records.update(bf16_recs)
    check_kernels(cut[0], gen, "f64", (8, 128, 77), 0, {}, TENANTS)
    check_dense_kernels(cut[0], gen, "f64", (8, 128, 77), 0, None)

    # -- 3. the solves at real-sim size ------------------------------------
    log(f"== 3. real-sim solves, b = 8, iters = {args.iters} (the dual's "
        "metrics make one pass over X per inner iteration)")
    d, n = X.shape
    idx_p = core.sample_blocks(gen, d, 8, args.iters)
    idx_d = core.sample_blocks(gen, n, 8, args.iters)
    stats = {}
    paths["single solves"] = run_solves(X, y, lam, idx_p, idx_d, args.iters,
                                        stats)
    log("== 3b. where a solve's time goes (profiler trace)")
    where_time_goes(X, y, lam, idx_p, idx_d, min(64, args.iters), stats)

    # -- 4. f64 exactness --------------------------------------------------
    log("== 4. f64 exactness through the kernels (8x-cut real-sim)")
    exactness_f64(cut, gen, 200)

    # -- 5. the tenant-batched engine --------------------------------------
    log(f"== 5. batched engine, real-sim, T = {TENANTS}, b = 8, s = 16, "
        f"{BATCHED_ITERS} iterations")
    paths["batched engine"] = batched_engine(X, y, lam, gen, BATCHED_ITERS,
                                             stats)

    # -- 6. the solve service ----------------------------------------------
    log("== 6. solve service, real-sim, 24 requests, 16 slots, chunks of 32, "
        "128 iterations each")
    paths["service"] = service_run(X, y, lam, gen, stats)

    # -- 7. the baselines --------------------------------------------------
    log("== 7. baselines at real-sim: CholeskyQR through K8, CG through "
        "K2 / K6, TSQR; f64 on the 8x cuts")
    records["gram_dense"] = k8_full_shape(X, lam, 2)
    paths["baselines"] = baselines(X, y, lam, cut, gen, stats)

    # -- 8. accelerated, guards, faults and recovery ----------------------
    log(f"== 8. accelerated, guards, faults and recovery, real-sim, b = 8, "
        f"{args.iters} iterations ({FAULT_ITERS} for the fault matrix, "
        f"{SUPERVISED_ITERS} supervised)")
    paths["recovery"] = recovery_run(X, y, lam, cut, gen, args.iters, stats)

    # -- 9. the sharded and pipelined backends -----------------------------
    log(f"== 9. sharded and pipelined backends, real-sim, {DIST_RANKS} gloo "
        f"ranks on one card (wire times: gloo, host-staged), b = 8, "
        f"{DIST_ITERS} iterations")
    paths["sharded"], stats["phase9_s"] = timed(
        lambda: distributed_run(X, y, lam, cut, gen, stats, args.seed))
    log(f"  phase 9 took {stats['phase9_s']:.1f} s")

    # -- 10. the contract engine --------------------------------------------
    log(f"== 10. contract engine: plan pass, contract pass on {DIST_RANKS} "
        "gloo ranks on one card, memory checks at real-sim, cost model")
    paths["contracts"], stats["phase10_s"] = timed(
        lambda: contract_engine(X, y, lam, stats, args.seed))
    log(f"  phase 10 took {stats['phase10_s']:.1f} s")
    del X, y, cut
    torch.cuda.empty_cache()

    # -- 11. the LM at llama3.2-3b's full width -----------------------------
    log("== 11. the LM: llama3.2-3b at its published width (random weights):"
        " f32 exactness, the LM probe through K3 / K4, bf16 serving")
    paths["lm probe"], stats["phase11_s"] = timed(
        lambda: lm_phase(args.seed, stats))
    log(f"  phase 11 took {stats['phase11_s']:.1f} s")
    torch.cuda.empty_cache()

    # -- 12. the other bodies at their published widths ----------------------
    log("== 12. the LM bodies: mamba2-370m, phi3.5-moe-42b, "
        "seamless-m4t-large-v2 at their published widths, jamba-1.5-large's "
        "interleave at its reduced widths (random weights)")
    paths["lm families"], stats["phase12_s"] = timed(
        lambda: families_phase(args.seed, stats))
    log(f"  phase 12 took {stats['phase12_s']:.1f} s")
    torch.cuda.empty_cache()

    # -- 13. training ---------------------------------------------------------
    # phases 13f-19 share one world of four gloo ranks (a spawn is 9-13 s);
    # its ranks give their cached blocks back to the card between phases
    world = spawn_world(dev, SEQ_RANKS, kernels=True)
    try:
        log("== 13. training: llama3.2-3b's gradients and step card against "
            "CPU (f64, 2 layers), its full config's steps (bf16, 28 "
            "layers), gradient accumulation, cpu-small's learning and exact "
            "resume, the elastic restart (random weights)")
        paths["train"], stats["phase13_s"] = timed(
            lambda: train_phase(args.seed, stats, world=world))
        log(f"  phase 13 took {stats['phase13_s']:.1f} s")
        torch.cuda.empty_cache()
        release_ranks(world)

        # -- 14. the dry run, flash-decoding, the batched cells, lasso ------
        log(f"== 14. flash-decoding and decode on a sequence-sharded cache "
            f"on {SEQ_RANKS} gloo ranks, the LM dry run and roofline, the "
            "batched solver dry-run cells, the lasso entry point")
        paths["lasso"], stats["phase14_s"] = timed(
            lambda: dryrun_phase(args.seed, stats, world=world))
        log(f"  phase 14 took {stats['phase14_s']:.1f} s")
        release_ranks(world)

        # -- 15. experts sharded over ranks -----------------------------------
        log(f"== 15. experts sharded over {EP_RANKS} gloo ranks on one card "
            "(phase 14's): dbrx's and jamba's MoE blocks, dbrx decode and "
            "serving, a phi3.5-moe train step, the MoE dry-run cells "
            "(random weights)")
        paths["experts"], stats["phase15_s"] = timed(
            lambda: experts_phase(args.seed, stats, world=world))
        log(f"  phase 15 took {stats['phase15_s']:.1f} s")
        release_ranks(world)

        # -- 16. the production layout on a grid of ranks ---------------------
        log(f"== 16. the reference's production layout on a grid of "
            f"{GRID_RANKS} gloo ranks on one card (phase 14's): ZeRO-1 on "
            "(4, 1) against the replicated world, tensor parallelism (and "
            "FSDP) on (2, 2) against one process, a restart 2 x 2 -> 1 x 2, "
            "the dry run on 16x16 and 2x16x16 (random weights)")
        paths["grid"], stats["phase16_s"] = timed(
            lambda: grid_phase(args.seed, stats, world=world))
        log(f"  phase 16 took {stats['phase16_s']:.1f} s")
        release_ranks(world)

        # -- 17. serving in the production layout on a grid of ranks ----------
        log(f"== 17. serving in the reference's production layout on a "
            f"{SERVE_GRID} grid of {GRID_RANKS} gloo ranks on one card (phase "
            "14's): prefill and decode under both cache layouts against one "
            "process (f32 and f64), the bf16 engine at 28 layers against "
            "the grid's greedy oracle (random weights)")
        paths["grid serving"], stats["phase17_s"] = timed(
            lambda: grid_serve_phase(args.seed, stats, world=world))
        log(f"  phase 17 took {stats['phase17_s']:.1f} s")
        release_ranks(world)

        # -- 18. the encoder-decoder and the vlm on a grid of ranks -----------
        log(f"== 18. seamless-m4t-large-v2 and llava-next-34b on a "
            f"{FAMILY_GRID} grid of {GRID_RANKS} gloo ranks on one card "
            "(phase 14's): a train step of each against one process, "
            "prefill and decode under both cache layouts against one "
            "process (f32 and f64), bf16 decode timing (random weights)")
        paths["grid families"], stats["phase18_s"] = timed(
            lambda: family_grid_phase(args.seed, stats, world=world))
        log(f"  phase 18 took {stats['phase18_s']:.1f} s")
        release_ranks(world)

        # -- 19. the ssm family on a grid of ranks ----------------------------
        log(f"== 19. mamba2-370m on a {SSM_GRID} grid of {GRID_RANKS} gloo "
            "ranks on one card (phase 14's): a train step against one "
            "process, prefill and decode under both cache layouts against "
            "one process (f32 and f64), the bf16 engine at 48 layers "
            "against the grid's greedy oracle (random weights)")
        paths["grid ssm"], stats["phase19_s"] = timed(
            lambda: ssm_grid_phase(args.seed, stats, world=world))
        log(f"  phase 19 took {stats['phase19_s']:.1f} s")
    finally:
        world.close()

    if args.parent:     # after this process's last profiler trace
        parent_after = parent_bf16_times(args.parent, args.seed, args.reps)
        log(f"  the parent design's bf16 packets again: {parent_after}")
        log_parent_turns(records, parent_before, parent_after)
    else:
        log_parent_turns(records, None, None)

    # Each path's own kernels must have run on it; the line counts the
    # launches of all counted paths.
    on_path = {"single solves": [k.name for k in gk.KERNELS[:4]],
               "batched engine": [k.name for k in gk.KERNELS[:6]],
               "service": [k.name for k in gk.KERNELS[:6]],
               "baselines": [k.name for k in (gk.ROWS_APPLY, gk.ROWS_MATVEC,
                                               gk.DENSE_PACKET,
                                               gk.DENSE_GRAM)],
               "recovery": [k.name for k in gk.KERNELS[:4]],
               "sharded": [k.name for k in gk.KERNELS[:6]],
               "contracts": [k.name for k in gk.KERNELS[:4]],
               "bf16 packets": [k.name for k in gk.BF16_KERNELS],
               "lm probe": [gk.COLS_PACKET.name, gk.COLS_APPLY.name],
               "lasso": [gk.ROWS_PACKET.name, gk.ROWS_APPLY.name]}
    for path, names in on_path.items():
        idle = [name for name in names if paths[path][name] == 0]
        if idle:
            raise AssertionError(f"{idle} never ran on the {path} path")
    kernels = []
    for info in gk.KERNELS + gk.BF16_KERNELS:
        rec = dict(records[info.name])
        rec["launches"] = sum(c[info.name] for c in paths.values())
        rec["launches_by_path"] = {p: c[info.name]
                                   for p, c in paths.items()}
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
