"""Tile selection for the Hopper Gram-packet kernels: the contraction chunk
``bk`` per ``(m, K, dtype, layout)``.

The CUDA packet kernels (``csrc/dense_tile.cuh``) cut the contraction K (n
for the row layout, d for the column layout) into ``ceil(K / bk)`` chunks
of length ``bk``, one block per (lower G tile, chunk); the chunk count is
reckoned here in tiles of :data:`TILE` = 32, whatever tile the kernel
runs.  ``bk`` is a multiple of :data:`BK`.

The default ``bk`` fills the card: it aims at :data:`TARGET_BLOCKS` blocks
for the layout but keeps at least :data:`MIN_STEPS` shared-memory steps per
block.  The row gather is coalesced and runs best with eight 64-thread
blocks per SM, so that some blocks compute while others wait on their loads;
the column gather's scattered reads ran best with about one block per SM in
the chunk sweep (``repro_torch.launch.tile_sweep``).  The pick is a function
of the shapes and layout alone, so the summation order of a packet is fixed
for a given ``(m, K, layout)``.

``_TABLE`` is where measured picks go, keyed on power-of-two buckets of
``(m, K)`` with the dtype name and layout.  It starts empty: no Hopper sweep
has been run yet.
"""
from __future__ import annotations

import torch

TILE = 32             # G tile edge the kernels are compiled for
BK = 32               # contraction step staged in shared memory
TARGET_BLOCKS = {"rows": 8 * 132, "cols": 132}   # per layout, 132-SM H100
MIN_STEPS = 8         # contraction steps per block, at least
MAX_SPLITS = 65535    # gridDim.y limit

LAYOUTS = ("rows", "cols")

_TABLE: dict[tuple[int, int, str, str], int] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _bucket(x: int) -> int:
    b = 1
    while b < x:
        b *= 2
    return b


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(
            f"unknown operand layout {layout!r}; expected one of {LAYOUTS}")


def lower_tiles(m: int) -> int:
    nt = _cdiv(m, TILE)
    return nt * (nt + 1) // 2


def default_chunk(m: int, K: int, layout: str = "rows") -> int:
    """Contraction chunk that spreads an (m, K) packet over the card."""
    want = max(1, TARGET_BLOCKS[layout] // lower_tiles(m))
    splits = max(1, min(want, K // (BK * MIN_STEPS)))
    chunk = _cdiv(_cdiv(max(K, 1), splits), BK) * BK
    return max(chunk, _cdiv(_cdiv(max(K, 1), MAX_SPLITS), BK) * BK)


def pick_tiles(m: int, K: int, dtype: torch.dtype, layout: str = "rows"
               ) -> int:
    """``bk`` for an (m samples, K contraction) packet in ``layout``: a
    table hit, else ``default_chunk(m, K, layout)``."""
    _check_layout(layout)
    key = (_bucket(max(m, 1)), _bucket(max(K, 1)), str(dtype).split(".")[-1],
           layout)
    if key in _TABLE:
        return _TABLE[key]
    return default_chunk(m, K, layout)
