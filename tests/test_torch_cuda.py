"""The port on the card: each CUDA kernel against its plain version, and the
solves through the kernels.  Every test carries the ``cuda`` marker and skips
with a reason on a machine without a CUDA device (the kernels have no CPU
mode).  This file imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: kernel against plain version, relative Frobenius 1e-5 in f32 (the
split contraction sums in another order than cuBLAS), for each output and for
G's cross terms alone (entries of two different indices), and 1e-12 in f64;
CA(s) against classical through the kernels, relative 1e-10 in f64.
"""
import pytest
import torch

from repro_torch import core
from repro_torch.kernels import gram as gk
from repro_torch.kernels.gram import ref as tref

pytestmark = pytest.mark.cuda

KERNELS = {"rows_packet": (gk.gram_packet_sampled_rows,
                           tref.gram_packet_sampled_ref),
           "rows_apply": (gk.panel_apply_rows, tref.panel_apply_ref),
           "cols_packet": (gk.gram_packet_sampled_cols,
                           tref.gram_packet_sampled_cols_ref),
           "cols_apply": (gk.panel_apply_cols, tref.panel_apply_cols_ref)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).double().norm() / b.double().norm())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("m", [1, 8, 77, 200])
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_matches_plain_version_on_card(cuda_device, kernel, m, dtype,
                                              tol):
    g = torch.Generator(device=cuda_device).manual_seed(m)
    d, n = 300, 2001
    X = torch.randn((d, n), generator=g, device=cuda_device, dtype=dtype)
    layout, kind = kernel.split("_")
    samples, K = (d, n) if layout == "rows" else (n, d)
    flat = torch.randint(0, samples, (m,), generator=g, device=cuda_device,
                         dtype=torch.int32)
    flat[-1] = flat[0]                                 # a duplicate index
    vec = torch.randn((K if kind == "packet" else m,), generator=g,
                      device=cuda_device, dtype=dtype)
    kern, plain = KERNELS[kernel]
    got, want = kern(X, flat, vec), plain(X, flat, vec)
    got = got if kind == "packet" else (got,)
    want = want if kind == "packet" else (want,)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel(a, b) <= tol
    if kind == "packet":
        assert torch.equal(got[0], got[0].T)         # mirrored exactly
        same = flat[:, None] == flat[None, :]
        if not bool(same.all()):
            assert _rel(got[0].masked_fill(same, 0.0),
                        want[0].masked_fill(same, 0.0)) <= tol


def test_kernel_refuses_bad_indices_on_card(cuda_device):
    X = torch.zeros((5, 7), device=cuda_device)
    flat = torch.tensor([0, 5], dtype=torch.int32, device=cuda_device)
    with pytest.raises(IndexError):
        gk.gram_packet_sampled_rows(X, flat, torch.zeros(7,
                                                         device=cuda_device))
    with pytest.raises(TypeError, match="bf16"):
        gk.panel_apply_cols(X.to(torch.bfloat16), flat[:1],
                            torch.zeros(1, device=cuda_device,
                                        dtype=torch.bfloat16))


@pytest.mark.parametrize("form", ["primal", "dual"])
def test_solves_run_through_the_kernels_and_match_classical(cuda_device,
                                                            form):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    d, n, b, iters = 40, 90, 4, 23
    X = torch.randn((d, n), generator=g, device=cuda_device,
                    dtype=torch.float64)
    y = torch.randn((n,), generator=g, device=cuda_device,
                    dtype=torch.float64)
    solve = core.ca_bcd if form == "primal" else core.ca_bdcd
    idx = core.sample_blocks(g, d if form == "primal" else n, b, iters)
    gk.reset_launch_counts()
    base = solve(X, y, 0.1, b, 1, iters, idx=idx)
    ca = solve(X, y, 0.1, b, 5, iters, idx=idx)
    ref = solve(X, y, 0.1, b, 5, iters, idx=idx, impl="ref")
    packet, apply = ((gk.ROWS_PACKET, gk.ROWS_APPLY) if form == "primal"
                     else (gk.COLS_PACKET, gk.COLS_APPLY))
    assert packet.launches == iters + -(-iters // 5)
    assert apply.launches == 2 * iters
    assert _rel(ca.w, base.w) <= 1e-10 and _rel(ca.alpha, base.alpha) <= 1e-10
    assert _rel(ca.w, ref.w) <= 1e-10
