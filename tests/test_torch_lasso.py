"""The lasso entry point (``launch/lasso.py``, the twin of
``examples/lasso.py``) against the reference's proximal solver
(``impl="ref"``, f64) on the same numpy X, y and index stream.

Tolerances: the port's s = 1 and s = 20 iterates and objective series
against the reference's at rtol 1e-10 / atol 1e-12 (``test_torch_proximal``'s
bar: XLA and ATen sum and factor in different orders, a few ulps apart,
over 600 iterations); s = 20 against s = 1 within the reference's own bar,
1e-8; the 16 true coordinates recovered.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro_torch.launch import lasso

from _x64 import x64_mode  # noqa: F401  (autouse fixture)

RTOL, ATOL = 1e-10, 1e-12


@pytest.fixture(scope="module")
def port():
    return lasso.main(device="cpu")


def test_lasso_recovers_the_support_with_one_twentieth_the_syncs(port):
    assert port["deviation"] < lasso.TOL
    assert port["recovered"] == lasso.K and port["nnz"] < lasso.D // 2
    assert port["syncs"] == {"classical": 600, "ca": 30}


@pytest.mark.parametrize("s", [1, lasso.S])
def test_lasso_matches_the_reference_proximal_solver(port, s):
    X, y, _, lam1 = lasso.problem(0)
    idx = lasso.index_stream(0).numpy().astype(np.int32)
    ref = J.get_solver("proximal", "local")(
        jnp.asarray(X), jnp.asarray(y), lasso.LAM, lasso.B, s, lasso.ITERS,
        None, idx=jnp.asarray(idx), lam1=lam1, impl="ref")
    w = port["w_classical"] if s == 1 else port["w"]
    np.testing.assert_allclose(w.numpy(), np.asarray(ref.w), rtol=RTOL,
                               atol=ATOL)
    solve = lasso.get_solver("proximal", "local")
    mine = solve(torch.from_numpy(X), torch.from_numpy(y), lasso.LAM,
                 lasso.B, s, lasso.ITERS, idx=torch.from_numpy(idx),
                 lam1=lam1)
    for key in ("objective", "nnz"):
        np.testing.assert_allclose(mine.history[key].numpy(),
                                   np.asarray(ref.history[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)


def test_lasso_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lasso.main()
