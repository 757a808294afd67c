"""The port's sampling and block subproblem solves against the reference.

``solve_spd``, ``block_forward_substitution`` and ``overlap_matrix`` take the
same numpy inputs on both sides (f64, rtol 1e-10 / atol 1e-12: the two
Cholesky implementations order their sums differently).  ``sample_blocks``
draws from a ``torch.Generator``, whose stream cannot equal ``jax.random``'s,
so it is tested on properties only.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.sampling import overlap_matrix as j_overlap
from repro.core.subproblem import block_forward_substitution as j_bfs
from repro.core.subproblem import solve_spd as j_solve
from repro_torch.core import (block_forward_substitution, overlap_matrix,
                              sample_blocks, solve_spd)

from _x64 import x64_mode  # noqa: F401  (autouse fixture)

RTOL, ATOL = 1e-10, 1e-12


def _spd(k, rng, ridge=0.5):
    B = rng.standard_normal((k, k + 3))
    return B @ B.T / (k + 3) + ridge * np.eye(k)


@pytest.mark.parametrize("k", [1, 4, 8, 17])
def test_solve_spd_matches_reference(k):
    rng = np.random.default_rng(k)
    A, rhs = _spd(k, rng), rng.standard_normal(k)
    got = solve_spd(torch.from_numpy(A), torch.from_numpy(rhs))
    want = j_solve(jnp.asarray(A), jnp.asarray(rhs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_solve_spd_not_positive_definite_gives_nan_like_reference():
    A = np.array([[1.0, 2.0], [2.0, 1.0]])
    rhs = np.ones(2)
    got = solve_spd(torch.from_numpy(A), torch.from_numpy(rhs))
    want = np.asarray(j_solve(jnp.asarray(A), jnp.asarray(rhs)))
    assert np.isnan(want).all() and torch.isnan(got).all()


@pytest.mark.parametrize("s,b", [(1, 4), (3, 4), (4, 2), (2, 8), (5, 1)])
def test_block_forward_substitution_matches_reference(s, b):
    rng = np.random.default_rng(10 * s + b)
    sb = s * b
    flat = rng.integers(0, 2 * b, sb)          # duplicates across blocks
    O = (flat[:, None] == flat[None, :]).astype(np.float64)
    B = rng.standard_normal((sb, 3 * sb))
    A = B @ B.T / (3 * sb) + 0.3 * O
    base = rng.standard_normal(sb)
    got = block_forward_substitution(torch.from_numpy(A),
                                     torch.from_numpy(base), s, b)
    want = j_bfs(jnp.asarray(A), jnp.asarray(base), s, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_block_forward_substitution_solves_the_lower_system():
    """With A's strictly upper blocks ignored, the sweep is a block lower
    triangular solve: L x = base."""
    rng = np.random.default_rng(7)
    s, b = 4, 3
    A = _spd(s * b, rng)
    x = block_forward_substitution(torch.from_numpy(A),
                                   torch.from_numpy(rng.standard_normal(12)),
                                   s, b)
    L = A.copy()
    for i in range(s):
        for j in range(i + 1, s):
            L[i * b:(i + 1) * b, j * b:(j + 1) * b] = 0
    base = L @ x.numpy()
    x2 = block_forward_substitution(torch.from_numpy(A),
                                    torch.from_numpy(base), s, b)
    np.testing.assert_allclose(x2.numpy(), x.numpy(), rtol=1e-10, atol=1e-12)


def test_overlap_matrix_matches_reference():
    flat = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], dtype=np.int32)
    got = overlap_matrix(torch.from_numpy(flat))
    want = np.asarray(j_overlap(jnp.asarray(flat)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(torch.diagonal(got), torch.ones(10, dtype=got.dtype))


@pytest.mark.parametrize("n_total,b,iters", [(50, 8, 30), (9, 9, 4),
                                             (1000, 1, 7)])
def test_sample_blocks_properties(n_total, b, iters):
    idx = sample_blocks(torch.Generator().manual_seed(1), n_total, b, iters)
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (iters, b)
    assert int(idx.min()) >= 0 and int(idx.max()) < n_total
    for row in idx:                              # no replacement in a row
        assert len(set(row.tolist())) == b


def test_sample_blocks_deterministic_in_the_generator_seed():
    a = sample_blocks(torch.Generator().manual_seed(3), 100, 8, 20)
    b = sample_blocks(torch.Generator().manual_seed(3), 100, 8, 20)
    c = sample_blocks(torch.Generator().manual_seed(4), 100, 8, 20)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_sample_blocks_draws_rows_independently():
    """Rows are independent draws, not slices of one permutation: 200 rows
    of 4 from 10 cover every index, many times over."""
    idx = sample_blocks(torch.Generator().manual_seed(0), 10, 4, 200)
    assert set(idx.flatten().tolist()) == set(range(10))


def test_sample_blocks_rejects_bad_arguments():
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="block size"):
        sample_blocks(g, 5, 6, 2)
    with pytest.raises(ValueError, match="block size"):
        sample_blocks(g, 5, 0, 2)
    with pytest.raises(ValueError, match="sampling mode"):
        sample_blocks(g, 5, 2, 2, mode="stratified")
    with pytest.raises(ValueError, match="shard count"):
        sample_blocks(g, 6, 2, 2, mode="shard_balanced")
