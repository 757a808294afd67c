"""Coordinate-block sampling for (CA-)BCD / (CA-)BDCD.

The paper samples ``b`` coordinates uniformly at random without replacement
per iteration (Algorithms 1-4).  The CA variants consume the same index
stream as the classical ones, which is what makes their exact equivalence
testable: the stream is drawn once from an explicit ``torch.Generator`` and
handed to both.  ``torch.Generator`` and ``jax.random`` give different
streams from one seed, so tests compare properties, never streams.
"""
from __future__ import annotations

import torch

MODES = ("global_uniform",)


def sample_blocks(generator: torch.Generator, n_total: int, b: int,
                  iters: int, mode: str = "global_uniform") -> torch.Tensor:
    """Sample ``iters`` coordinate blocks of size ``b`` from ``[n_total]``.

    Returns int32 ``(iters, b)`` on the generator's device.  Within a row: no
    replacement.  Across rows: independent draws (the paper's scheme).
    Deterministic in the generator's state.
    """
    if mode not in MODES:
        raise ValueError(
            f"unknown sampling mode {mode!r}; expected one of {MODES}")
    if not 1 <= b <= n_total:
        raise ValueError(f"block size b={b} must be in [1, n_total={n_total}]")
    weights = torch.ones((iters, n_total), device=generator.device)
    idx = torch.multinomial(weights, b, replacement=False,
                            generator=generator)
    return idx.to(torch.int32)


def overlap_matrix(flat_idx: torch.Tensor) -> torch.Tensor:
    """O[p, q] = 1 if flat_idx[p] == flat_idx[q]: the paper's intersection
    term, ``(sb, sb)`` for an outer iteration of ``s`` blocks of ``b``, in the
    default float dtype."""
    eq = flat_idx[:, None] == flat_idx[None, :]
    return eq.to(torch.get_default_dtype())
