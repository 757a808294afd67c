"""Slot-table continuous batching: a FIFO admission queue, a fixed-width
table of slots each bound to at most one live request, and power-of-two
bucketing of the live width.

The port's own copy of the reference's ``repro/serve/slots.py`` (numpy
only); the domain state -- a solver's per-slot carries -- stays in the
engine that owns the table.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def bucket_pow2(n: int, min_bucket: int, cap: int) -> int:
    """Smallest power of two >= ``n``, floored at ``min_bucket`` and clipped
    to ``cap``: padding live work up to a bucket keeps the number of
    distinct batch widths logarithmic in the table width."""
    if n < 0:
        raise ValueError(f"bucket_pow2: negative size {n}")
    b = min_bucket
    while b < n:
        b *= 2
    return min(b, cap)


@dataclasses.dataclass
class SlotRequest:
    """One queued or running request.  ``payload`` is the engine's input,
    ``out`` collects its output, ``slot`` is -1 until admitted."""
    rid: int
    payload: object
    out: list
    slot: int = -1
    done: bool = False


class SlotTable:
    """Fixed-width slot table + FIFO queue.

    ``submit`` enqueues, ``admit`` moves queued requests into free slots (the
    engine installs its per-slot state for each), ``retire`` frees a slot
    and marks its request done.  ``active`` is a numpy bool mask over slots.
    """

    def __init__(self, slots: int):
        if slots <= 0:
            raise ValueError(f"SlotTable needs >= 1 slot, got {slots}")
        self.slots = slots
        self.active = np.zeros((slots,), bool)
        self.slot_req: list[int | None] = [None] * slots
        self.queue: list[SlotRequest] = []
        self.requests: dict[int, SlotRequest] = {}
        self._next_rid = 0

    def submit(self, payload) -> int:
        rid = self._next_rid
        self._next_rid += 1
        req = SlotRequest(rid, payload, [])
        self.queue.append(req)
        self.requests[rid] = req
        return rid

    def admit(self) -> list[SlotRequest]:
        """Move queued requests into free slots (FIFO into the first free
        slots), mark them active and return them."""
        admitted = []
        for s in range(self.slots):
            if self.active[s] or not self.queue:
                continue
            req = self.queue.pop(0)
            req.slot = s
            self.slot_req[s] = req.rid
            self.active[s] = True
            admitted.append(req)
        return admitted

    def retire(self, slot: int) -> SlotRequest | None:
        """Free ``slot``; returns the request that occupied it (now done)."""
        rid = self.slot_req[slot]
        req = None
        if rid is not None:
            req = self.requests[rid]
            req.done = True
        self.active[slot] = False
        self.slot_req[slot] = None
        return req

    def request_in(self, slot: int) -> SlotRequest:
        rid = self.slot_req[slot]
        if rid is None:
            raise KeyError(f"slot {slot} is empty")
        return self.requests[rid]

    def active_slots(self) -> list[int]:
        return [s for s in range(self.slots) if self.active[s]]

    @property
    def any_active(self) -> bool:
        return bool(self.active.any())

    @property
    def pending(self) -> int:
        return len(self.queue)
