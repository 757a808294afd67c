"""Deterministic fault injection for the s-step solvers (a test-only hook).

A :class:`FaultPlan` describes ONE fault: its kind, the outer step it fires
at and, for a sharded run, its shard.  The engine takes it as
``SolverPlan.fault`` and calls its two hooks in every outer step
(``engine._outer_step``):

* ``apply_packet(G, r, step=, rank=)`` damages the raw packet (on a shard,
  this rank's local contribution) before the health word is computed, so
  that the guard sees injected damage the way it would see real damage (a
  NaN packet, a bit-flipped Gram entry, a zeroed contribution);
* ``apply_health(health, step=, rank=)`` damages the health word itself;
  only ``drop_shard`` does (a dropped worker contributes neither data nor
  presence, so its whole word is zeroed and the reduced presence count
  comes up short: ``GUARD_SHARD_LOSS``).

The port's driver loops on the host, so ``step`` is a python int and a hook
that does not fire returns its inputs untouched, with no device operation.
``rank`` is the caller's rank in its group: a sharded run is hit on
``shard`` only, a local run (``rank`` None) always.
The bit-flip entry is drawn from a seed-keyed ``random.Random``, keyed as
in the reference on the packet's shape as a tuple, so that both packages
flip the same entry.  ``device_loss`` is inert here: losing a device is the
process-level event that the supervisor (``repro_torch.faults.supervisor``)
simulates.
"""
from __future__ import annotations

import dataclasses
import random

import torch

KINDS = ("nan_packet", "bitflip", "drop_shard", "device_loss")

# Bit-flip scale: adding 2^46 * (1 + |x|) to a float perturbs high-exponent
# bits the way a flipped exponent bit would: large enough to blow the
# magnitude envelope, finite so that the nonfinite guard does NOT fire (the
# two detection paths stay apart).
_BITFLIP_SCALE = 2.0 ** 46


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One injected fault.

    Args:
      kind: one of :data:`KINDS`.
      step: global outer-step index at which the fault fires (``step0``
        aware: a resumed segment sees the same global numbering).
      shard: target shard of a sharded run (a local run is always hit).
      seed: keys the deterministic bit-flip entry.
      survivors: for ``device_loss``, the world size after the loss (read
        by the supervisor; ``None``: half the current world, at least 1).
    """
    kind: str
    step: int
    shard: int = 0
    seed: int = 0
    survivors: int | None = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind={self.kind!r} must be one of {KINDS}")
        if self.step < 0:
            raise ValueError(f"step={self.step} must be >= 0")
        if self.shard < 0:
            raise ValueError(f"shard={self.shard} must be >= 0")

    def _fire(self, step: int, rank: int | None) -> bool:
        return int(step) == self.step and (rank is None or rank == self.shard)

    def bitflip_entry(self, shape) -> tuple[int, int]:
        """The (i, j) of the Gram entry the bit flip hits in a packet of
        ``shape``."""
        rng = random.Random(f"{self.seed}:{tuple(shape)}")
        i = rng.randrange(shape[0])
        j = rng.randrange(shape[1])
        return i, j

    def apply_packet(self, G, r, *, step, rank=None):
        if self.kind == "device_loss" or not self._fire(step, rank):
            return G, r
        if self.kind == "nan_packet":
            return (torch.full_like(G, float("nan")),
                    torch.full_like(r, float("nan")))
        if self.kind == "bitflip":
            i, j = self.bitflip_entry(G.shape)
            entry = G[i, j]
            scale = torch.tensor(_BITFLIP_SCALE, dtype=G.dtype,
                                 device=G.device)
            G = G.clone()
            G[i, j] = entry + scale * (1 + torch.abs(entry))
            return G, r
        return torch.zeros_like(G), torch.zeros_like(r)      # drop_shard

    def apply_health(self, health, *, step, rank=None):
        if self.kind == "drop_shard" and self._fire(step, rank):
            return torch.zeros_like(health)
        return health
