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

bf16 input (the packets K1, K3 and K7 on the tensor cores) has its own
default (:func:`default_chunk` with the dtype): :data:`MMA_TARGET_BLOCKS`
blocks of its wider tile (:func:`mma_edge`), which reads each sampled
element once; at m = 128 the f32 pick for the column layout would give its
one 128-tile 13 blocks.  The matvecs K5 / K6, which share the f32 chunk to
equal K3 / K1's r, have no bf16 build, so the f32 and f64 picks stay as
they were.

``_TABLE`` is where measured picks go, keyed on power-of-two buckets of
``(m, K)`` with the dtype name and layout.  It starts empty: no Hopper sweep
has been run yet.  :func:`register_table` and :func:`load_table` merge
entries into it, and a JSON table named by the ``REPRO_TORCH_GRAM_TUNING``
environment variable is merged at the first pick (the variable is the
port's own: its entries are one ``bk`` chunk, where the reference's
``REPRO_GRAM_TUNING`` table holds ``(bm, bk)`` pairs).  One entry serves
the packet (K1 / K3) and the matvec (K6 / K5) of its key alike, which is
what keeps the matvec's sums the packet's r; the plan pass
(``repro_torch.analysis.plan_pass``) checks every entry.
"""
from __future__ import annotations

import json
import os

import torch

TILE = 32             # G tile edge the kernels are compiled for
BK = 32               # contraction step staged in shared memory
TARGET_BLOCKS = {"rows": 8 * 132, "cols": 132}   # per layout, 132-SM H100
MIN_STEPS = 8         # contraction steps per block, at least
MAX_SPLITS = 65535    # gridDim.y limit
# bf16 (mma_tile): blocks to aim at per (layout, tile edge), from
# launch.tile_sweep's bf16 sweep -- one a SM of the 132-SM H100; two for the
# row layout's light 16-tile; a third of the SMs for the column layout's
# 128-tile, whose isolated reads come faster with fewer in flight (its
# chunk of 480 steps at real-sim) -- and the fewest contraction steps a
# chunk
MMA_TARGET_BLOCKS = {("rows", 16): 2 * 132, ("rows", 128): 132,
                     ("cols", 16): 132, ("cols", 128): 44}
MMA_MIN_STEPS = 64

LAYOUTS = ("rows", "cols")

_TABLE: dict[tuple[int, int, str, str], int] = {}
ENV_TABLE = "REPRO_TORCH_GRAM_TUNING"
_env_loaded = False


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


def mma_edge(m: int) -> int:
    """The tile edge of the bf16 packets (mma_tile) for m samples: 16 up to
    16 samples, else 128, the same for every row source."""
    return 16 if m <= 16 else 128


def default_chunk(m: int, K: int, layout: str = "rows",
                  dtype: torch.dtype | None = None) -> int:
    """Contraction chunk that spreads an (m, K) packet over the card; for
    bf16, :data:`MMA_TARGET_BLOCKS` blocks of the :func:`mma_edge` tile."""
    if dtype == torch.bfloat16:
        edge = mma_edge(m)
        nt = _cdiv(m, edge)
        want = _cdiv(MMA_TARGET_BLOCKS[(layout, edge)], nt * (nt + 1) // 2)
        splits = max(1, min(want, K // MMA_MIN_STEPS))
    else:
        want = max(1, TARGET_BLOCKS[layout] // lower_tiles(m))
        splits = max(1, min(want, K // (BK * MIN_STEPS)))
    chunk = _cdiv(_cdiv(max(K, 1), splits), BK) * BK
    return max(chunk, _cdiv(_cdiv(max(K, 1), MAX_SPLITS), BK) * BK)


def pick_tiles(m: int, K: int, dtype: torch.dtype, layout: str = "rows"
               ) -> int:
    """``bk`` for an (m samples, K contraction) packet in ``layout``: a
    table hit, else ``default_chunk(m, K, layout, dtype)``."""
    _check_layout(layout)
    if not _env_loaded:
        _load_env_table()
    key = (_bucket(max(m, 1)), _bucket(max(K, 1)), str(dtype).split(".")[-1],
           layout)
    if key in _TABLE:
        return _TABLE[key]
    return default_chunk(m, K, layout, dtype)


def register_table(mapping: dict) -> None:
    """Merge entries into the live table.  Keys are ``(m_bucket, K_bucket,
    dtype_name, layout)`` tuples or their JSON form ``"m,K,dtype,layout"``;
    values are the chunk ``bk``.  Nothing is checked here beyond the
    layout: the plan pass checks the entries."""
    for k, v in mapping.items():
        if isinstance(k, str):
            mb, kb, dt, layout = k.split(",")
            k = (int(mb), int(kb), dt, layout)
        _check_layout(k[3])
        _TABLE[(int(k[0]), int(k[1]), str(k[2]), k[3])] = int(v)


def load_table(path: str) -> int:
    """Merge a JSON table (``{"table": {key: bk}}`` or the bare mapping);
    returns the number of entries merged."""
    with open(path) as f:
        data = json.load(f)
    table = data.get("table", data)
    register_table(table)
    return len(table)


def _load_env_table() -> None:
    """Merge the table named by ``REPRO_TORCH_GRAM_TUNING`` once.  Setting
    the variable is an explicit opt-in: a path that does not exist raises
    instead of falling back to the built-in table, and goes on raising at
    every pick until the variable names a table that loads."""
    global _env_loaded
    path = os.environ.get(ENV_TABLE)
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"{ENV_TABLE}={path!r} does not exist; "
                                    "unset it or point it at a JSON table")
        load_table(path)
    _env_loaded = True


def table_snapshot() -> dict[str, int]:
    """JSON-serialisable copy of the live table."""
    if not _env_loaded:
        _load_env_table()
    return {f"{k[0]},{k[1]},{k[2]},{k[3]}": v
            for k, v in sorted(_TABLE.items())}


def table_entries() -> list[tuple[tuple[int, int, str, str], int]]:
    """Sorted ``(key, bk)`` pairs of the live table: the built-ins plus
    whatever :func:`register_table` and the environment's table merged."""
    if not _env_loaded:
        _load_env_table()
    return sorted(_TABLE.items())
