"""The port's Mamba-2 block (``repro_torch.models.mamba2``) against the
reference's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
block's weights are the reference's (its ``init_params`` on
``mamba_specs``), carried as numpy.  Tolerances:
* the chunked scan, against the reference's scan and against the
  token-by-token oracle, in f32: the reference's own 2e-4
  (``tests/test_mamba.py``), on values of order 1;
* f64 inputs: the scan computes in f32 whatever its inputs (the reference
  asks its products for f32 and carries an f32 state), so it is held to the
  f64 oracle at 2e-5, twenty times f32's error on these sums (read: up to
  4e-7), and its outputs are f32;
* the block and its decode step against the reference's, and the decode
  step against the block one token longer: atol 1e-4 on outputs of order
  0.1-1 (each side rounds its own f32 sums over 64 inputs and chunks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.models import init_params as jinit
from repro.models import mamba2 as JM
from repro_torch.configs import get_reduced
from repro_torch.models import mamba2 as TM

SSD_TOL = 2e-4
F64_TOL = 2e-5
BLOCK_TOL = 1e-4


def _inputs(seed, B=2, L=64, H=4, P=8, N=16, dtype=np.float32):
    rng = np.random.default_rng(seed)
    xdt = 0.5 * rng.standard_normal((B, L, H, P))
    dtA = -np.abs(0.1 * rng.standard_normal((B, L, H)))
    Bm = 0.5 * rng.standard_normal((B, L, N))
    Cm = 0.5 * rng.standard_normal((B, L, N))
    return tuple(a.astype(dtype) for a in (xdt, dtA, Bm, Cm))


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_chunked_matches_reference_and_naive(chunk):
    a = _inputs(0)
    y, S = TM.ssd_chunked(*_t(a), chunk)
    yj, Sj = JM.ssd_chunked(*_j(a), chunk)
    assert y.dtype == S.dtype == torch.float32
    _close(y, yj, SSD_TOL)
    _close(S, Sj, SSD_TOL)
    y_ref, S_ref = TM.naive_ssd(*_t(a))
    _close(y, y_ref, SSD_TOL)
    _close(S, S_ref, SSD_TOL)
    yn, Sn = JM.naive_ssd(*_j(a))
    _close(y_ref, yn, SSD_TOL)
    _close(S_ref, Sn, SSD_TOL)


@pytest.mark.parametrize("L", [64, 50])
def test_chunk_invariance_and_ragged_tail(L):
    """Chunks of 8 and 32 give the same scan; a length no multiple of the
    chunk pads its tail without moving the state."""
    a = _inputs(1, L=L)
    y8, s8 = TM.ssd_chunked(*_t(a), 8)
    y32, s32 = TM.ssd_chunked(*_t(a), 32)
    _close(y8, y32, SSD_TOL)
    _close(s8, s32, SSD_TOL)
    yj, sj = JM.ssd_chunked(*_j(a), 32)
    _close(y32, yj, SSD_TOL)
    _close(s32, sj, SSD_TOL)


def test_initial_state_continuity():
    """Splitting a sequence across two calls with the carried state S0 ==
    one call, as in the reference."""
    a = _t(_inputs(2, L=64))
    y_full, S_full = TM.ssd_chunked(*a, 16)
    first = tuple(t[:, :32] for t in a)
    second = tuple(t[:, 32:] for t in a)
    y1, S1 = TM.ssd_chunked(*first, 16)
    y2, S2 = TM.ssd_chunked(*second, 16, S0=S1)
    _close(torch.cat([y1, y2], 1), y_full, SSD_TOL)
    _close(S2, S_full, SSD_TOL)
    y2n, S2n = TM.naive_ssd(*second, S0=S1)
    _close(y2, y2n, SSD_TOL)
    _close(S2, S2n, SSD_TOL)


@pytest.mark.parametrize("chunk", [8, 64])
def test_f64_inputs_are_scanned_in_f32(chunk):
    a = _inputs(3, dtype=np.float64)
    y, S = TM.ssd_chunked(*_t(a), chunk)
    assert y.dtype == S.dtype == torch.float32
    y64, S64 = TM.naive_ssd(*_t(a))
    assert y64.dtype == torch.float64
    _close(y.double(), y64, F64_TOL)
    _close(S.double(), S64, F64_TOL)


def _block_setup(seed=0):
    jc = dataclasses.replace(j_reduced("mamba2_370m"), dtype=jnp.float32,
                             param_dtype=jnp.float32)
    tc = dataclasses.replace(get_reduced("mamba2_370m"), dtype=torch.float32,
                             param_dtype=torch.float32)
    pj = jinit(JM.mamba_specs(jc), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    # non-trivial decay, skip and step bias (their inits are 0, 1, 0)
    H = pj["A_log"].shape[0]
    pj = dict(pj, A_log=jnp.asarray(0.5 * rng.standard_normal(H), jnp.float32),
              D=jnp.asarray(rng.standard_normal(H), jnp.float32),
              dt_bias=jnp.asarray(0.3 * rng.standard_normal(H), jnp.float32))
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    return jc, tc, pj, pt, rng


@pytest.mark.parametrize("L", [64, 45])
def test_mamba_block_matches_reference(L):
    jc, tc, pj, pt, rng = _block_setup()
    x = rng.standard_normal((2, L, tc.d_model)).astype(np.float32)
    got = TM.mamba_block(pt, torch.from_numpy(x), tc)
    want = JM.mamba_block(pj, jnp.asarray(x), jc)
    assert got.shape == (2, L, tc.d_model)
    _close(got, want, BLOCK_TOL)


def test_mamba_decode_step_matches_reference():
    jc, tc, pj, pt, rng = _block_setup(1)
    B = 3
    state = {k: 0.5 * rng.standard_normal(v.shape).astype(np.float32)
             for k, v in TM.mamba_state_init(tc, B).items()}
    xt = rng.standard_normal((B, tc.d_model)).astype(np.float32)
    out, new = TM.mamba_decode_step(
        pt, {k: torch.from_numpy(v) for k, v in state.items()},
        torch.from_numpy(xt), tc)
    outj, newj = JM.mamba_decode_step(
        pj, {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(xt),
        jc)
    _close(out, outj, BLOCK_TOL)
    assert new.keys() == newj.keys()
    for k in new:
        assert new[k].dtype == (torch.float32)
        _close(new[k], newj[k], BLOCK_TOL)
    assert TM.mamba_state_init(tc, B)["ssm"].dtype == torch.float32


def test_decode_step_continues_the_block():
    """The block over L tokens with its state, then one decode step, gives
    the block's output at token L + 1 (the prefill + decode contract at
    the block's level)."""
    _, tc, _, pt, rng = _block_setup(2)
    x = torch.from_numpy(rng.standard_normal((2, 33, tc.d_model))
                         .astype(np.float32))
    full = TM.mamba_block(pt, x, tc)
    _, state = TM.mamba_block_with_state(pt, x[:, :32], tc)
    out, _ = TM.mamba_decode_step(pt, state, x[:, 32], tc)
    _close(out, full[:, 32], BLOCK_TOL)
