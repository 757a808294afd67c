"""Coordinate-block sampling for (CA-)BCD / (CA-)BDCD.

The paper samples ``b`` coordinates uniformly at random without replacement
per iteration (Algorithms 1-4).  The CA variants consume the same index
stream as the classical ones, which is what makes their exact equivalence
testable: the stream is drawn once from an explicit ``torch.Generator`` and
handed to both.  ``torch.Generator`` and ``jax.random`` give different
streams from one seed, so tests compare properties, never streams.

Two modes:

* ``global_uniform`` -- the paper's scheme: each block is drawn uniformly
  without replacement from ``[n_total]``.  Under a 1D layout of the sampled
  dimension the blocks can load-imbalance the shards (Thm. 4/5).
* ``shard_balanced`` -- each of ``P`` equal, contiguous ranges contributes
  ``b / P`` indices to every block, so a sharded gather of the sampled
  dimension touches every shard equally (:func:`sample_blocks_balanced`).
"""
from __future__ import annotations

import torch

MODES = ("global_uniform", "shard_balanced")


def _draw(generator: torch.Generator, rows: int, n_total: int,
          b: int) -> torch.Tensor:
    """``rows`` independent draws of ``b`` of ``[n_total]`` without
    replacement."""
    weights = torch.ones((rows, n_total), device=generator.device)
    return torch.multinomial(weights, b, replacement=False,
                             generator=generator)


def sample_blocks(generator: torch.Generator, n_total: int, b: int,
                  iters: int, mode: str = "global_uniform", *,
                  n_shards: int | None = None) -> torch.Tensor:
    """Sample ``iters`` coordinate blocks of size ``b`` from ``[n_total]``.

    Returns int32 ``(iters, b)`` on the generator's device.  Within a row: no
    replacement.  Across rows: independent draws (the paper's scheme).
    Deterministic in the generator's state.  ``mode="shard_balanced"``
    needs the shard count ``n_shards`` and goes to
    :func:`sample_blocks_balanced`.
    """
    if mode not in MODES:
        raise ValueError(
            f"unknown sampling mode {mode!r}; expected one of {MODES}")
    if not 1 <= b <= n_total:
        raise ValueError(f"block size b={b} must be in [1, n_total={n_total}]")
    if mode == "shard_balanced":
        if n_shards is None:
            raise ValueError(
                "mode='shard_balanced' needs the shard count: pass "
                "n_shards=P (or call sample_blocks_balanced directly)")
        return sample_blocks_balanced(generator, n_total, b, iters, n_shards)
    if n_shards is not None:
        raise ValueError("n_shards only applies to mode='shard_balanced'")
    return _draw(generator, iters, n_total, b).to(torch.int32)


def sample_blocks_balanced(generator: torch.Generator, n_total: int, b: int,
                           iters: int, n_shards: int) -> torch.Tensor:
    """Shard-balanced sampling: each of ``n_shards`` contiguous ranges of
    ``n_total / n_shards`` coordinates contributes ``b / n_shards`` indices,
    without replacement, to every block.  Requires ``b % n_shards == 0``
    and ``n_total % n_shards == 0``.  Returns int32 ``(iters, b)``, shard
    0's indices first in each row."""
    if b % n_shards != 0:
        raise ValueError(f"b={b} must be divisible by n_shards={n_shards}")
    if n_total % n_shards != 0:
        raise ValueError(
            f"n_total={n_total} must be divisible by n_shards={n_shards}")
    per, shard_len = b // n_shards, n_total // n_shards
    local = _draw(generator, iters * n_shards, shard_len, per)
    offset = torch.arange(n_shards, device=local.device) * shard_len
    idx = local.reshape(iters, n_shards, per) + offset[:, None]
    return idx.reshape(iters, b).to(torch.int32)


def overlap_matrix(flat_idx: torch.Tensor) -> torch.Tensor:
    """O[p, q] = 1 if flat_idx[p] == flat_idx[q]: the paper's intersection
    term, ``(sb, sb)`` for an outer iteration of ``s`` blocks of ``b``, in the
    default float dtype."""
    eq = flat_idx[:, None] == flat_idx[None, :]
    return eq.to(torch.get_default_dtype())
